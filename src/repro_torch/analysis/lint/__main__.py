"""swanlint CLI for the port.

    python -m repro_torch.analysis.lint                   # lint, gate
    python -m repro_torch.analysis.lint --json out.json   # + JSON report
    python -m repro_torch.analysis.lint --baseline b.json # gate on NEW

It exits 1 when an active finding is not in the baseline (without one:
any active finding).  Layer 2, the serve auditor, drives engines: the CPU
tests run it (``tests/test_torch_audit.py``) and ``chip_smoke.py``'s
``audit`` phase runs it on the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis.lint import (SKIPPED_RULES, load_baseline,
                                       make_report, new_findings, run_lint)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="swanlint: the port's static analysis")
    ap.add_argument("--root", default=".", help="repo root to scan")
    ap.add_argument("--baseline", default=None,
                    help="findings JSON whose fingerprints are accepted")
    ap.add_argument("--json", default=None,
                    help="write the full JSON report to this path")
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root)
    findings = run_lint(root)
    baseline = load_baseline(args.baseline) if args.baseline else None
    report = make_report(findings, baseline=baseline)
    counts = report["counts"]
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=1, sort_keys=True)
            fh.write("\n")

    for f in findings:
        mark = "suppressed" if f.suppressed else "ACTIVE"
        print(f"{f.path}:{f.line}: {f.rule} [{mark}] {f.message}")
    for rule, why in SKIPPED_RULES.items():
        print(f"{rule}: {why}")
    new = new_findings(findings, baseline)
    print(f"swanlint: {counts['total']} finding(s), "
          f"{counts['suppressed']} suppressed, {counts['active']} active, "
          f"{len(new)} new" + (" vs baseline" if baseline else ""))
    if new:
        for f in new:
            print(f"NEW: {f.path}:{f.line}: {f.rule} {f.message}",
                  file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
