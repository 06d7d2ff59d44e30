"""swanlint CLI for the port, with the reference CLI's flags.

    python -m repro_torch.analysis.lint                    # report findings
    python -m repro_torch.analysis.lint --check            # gate: fail on NEW
    python -m repro_torch.analysis.lint --check --audit-smoke
    python -m repro_torch.analysis.lint --write-baseline   # accept current state
    python -m repro_torch.analysis.lint --report out.json  # + JSON report

``--check`` compares active findings against the baseline
(``bench_out/LINT_BASELINE_torch.json`` unless ``--baseline`` names
another; the reference's ``bench_out/LINT_BASELINE.json`` is never read or
written) by line-number-free fingerprint and exits 1 only on findings not
in it, or on serve-audit failures.  Without ``--check`` it reports and
exits 0.  ``--audit-smoke`` adds Layer 2, the serve auditor, on the smoke
config on the CPU (``audit.run_audit(device="cpu", smoke=True)``);
``chip_smoke.py``'s ``audit`` phase runs it on the card.  ``--json`` is a
second spelling of ``--report``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis.lint import (DEFAULT_BASELINE, load_baseline,
                                       make_report, new_findings, run_lint)


def _write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(obj, fh, indent=1, sort_keys=True)
        fh.write("\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="swanlint: the port's static analysis")
    ap.add_argument("--root", default=".", help="repo root to scan")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on findings not in the baseline / on "
                         "audit failures")
    ap.add_argument("--audit-smoke", action="store_true",
                    help="run the serve auditor on the smoke config on "
                         "the CPU")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline JSON (default <root>/{DEFAULT_BASELINE})")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the current findings as the new baseline")
    ap.add_argument("--report", "--json", dest="report", default=None,
                    help="write the full JSON report to this path")
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root)
    base_path = args.baseline or os.path.join(root, DEFAULT_BASELINE)
    findings = run_lint(root)

    audit_checks = None
    if args.audit_smoke:
        from repro_torch.analysis.lint.audit import run_audit
        audit_checks = run_audit(device="cpu", smoke=True)

    baseline = load_baseline(base_path)
    report = make_report(findings, audit_checks, baseline)
    counts = report["counts"]

    if args.write_baseline:
        _write_json(base_path, {"tool": "swanlint",
                                "version": report["version"],
                                "findings": report["findings"]})
        print(f"baseline written: {base_path} "
              f"({counts['total']} finding(s))")
    if args.report:
        _write_json(args.report, report)

    for f in findings:
        mark = "suppressed" if f.suppressed else "ACTIVE"
        print(f"{f.path}:{f.line}: {f.rule} [{mark}] {f.message}")
    if audit_checks is not None:
        for c in audit_checks:
            print(f"audit {c.check}: {c.status.upper()} {c.detail}")
    new = new_findings(findings, baseline)
    n_audit_fail = counts.get("audit_failures", 0)
    print(f"swanlint: {counts['total']} finding(s), "
          f"{counts['suppressed']} suppressed, {counts['active']} active, "
          f"{len(new)} new vs baseline"
          + (f", {n_audit_fail} audit failure(s)"
             if audit_checks is not None else ""))

    if args.check and (new or n_audit_fail):
        for f in new:
            print(f"NEW: {f.path}:{f.line}: {f.rule} {f.message}",
                  file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
