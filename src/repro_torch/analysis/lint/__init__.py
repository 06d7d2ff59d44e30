"""swanlint for the port — static analysis of ``src/repro_torch/``,
``chip_smoke.py`` and ``examples/torch_*.py`` (port of
``repro/analysis/lint``).

Two layers:

* **Layer 1 (``repro_torch.analysis.lint.rules``)** — stdlib-``ast``
  rules over the port's standing constraints: its import floor (SWAN101:
  no jax, no reference package), no host syncs on the serve hot path
  (SWAN102), power-of-two shape bucketing in dispatch functions (SWAN103),
  sharding-spec completeness (SWAN104, skipped until the port has
  sharding) and MetricsRegistry-only observability (SWAN105).  No torch
  import: it runs anywhere.
* **Layer 2 (``repro_torch.analysis.lint.audit``)** — the serve auditor:
  it drives the engine matrix and holds its graphs, dispatch bodies and
  steps to the serve contract (graph counts, no host crossing, no
  collective, one launch per layer of each kernel, kernel prechecks).

CLI: ``python -m repro_torch.analysis.lint [--check] [--report out]
[--write-baseline] [--audit-smoke] [--baseline file]``, the reference
CLI's flags: under ``--check`` it exits non-zero on active findings not in
the baseline (``DEFAULT_BASELINE``, the port's own file) or on audit
failures.  The port's tree lints clean: a finding is fixed or suppressed
inline with a justification, so no baseline is committed.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, Iterable, List, Optional

from repro_torch.analysis.lint.rules import (RULES, Finding,
                                             lint_paths, lint_source)

__all__ = ["Finding", "RULES", "lint_source", "lint_paths",
           "collect_files", "run_lint", "make_report", "load_baseline",
           "new_findings", "DEFAULT_SCAN", "DEFAULT_BASELINE"]

# what Layer 1 walks by default: the port's package, its chip smoke run
# and its examples (tests are exempt — they seed violations on purpose)
DEFAULT_SCAN = ("src/repro_torch", "chip_smoke.py", "examples/torch_*.py")
# the port's baseline: the reference's is bench_out/LINT_BASELINE.json,
# which the port neither reads nor writes
DEFAULT_BASELINE = os.path.join("bench_out", "LINT_BASELINE_torch.json")


def collect_files(root: str, scan: Iterable[str] = DEFAULT_SCAN) -> List[str]:
    """Repo-relative ``.py`` paths under each entry of ``scan``: a
    directory (walked), a file or a glob."""
    out: List[str] = []
    for entry in scan:
        base = os.path.join(root, entry)
        if os.path.isdir(base):
            for dirpath, dirnames, filenames in os.walk(base):
                dirnames[:] = [x for x in dirnames if x != "__pycache__"]
                out += [os.path.join(dirpath, fn) for fn in filenames
                        if fn.endswith(".py")]
        else:
            out += [p for p in glob.glob(base) if p.endswith(".py")]
    return sorted({os.path.relpath(p, root) for p in out})


def run_lint(root: str, scan: Iterable[str] = DEFAULT_SCAN) -> List[Finding]:
    return lint_paths(root, collect_files(root, scan))


def make_report(findings: List[Finding],
                audit_checks: Optional[List] = None,
                baseline: Optional[Dict] = None) -> Dict:
    """JSON-serializable report: the full finding list, the
    active/suppressed split, the new-vs-baseline diff and optional Layer 2
    results."""
    new = new_findings(findings, baseline)
    rep: Dict = {
        "tool": "swanlint",
        "version": 1,
        "rules": RULES,
        "findings": [f.to_json() for f in findings],
        "counts": {
            "total": len(findings),
            "active": sum(not f.suppressed for f in findings),
            "suppressed": sum(f.suppressed for f in findings),
            "new": len(new),
        },
        "new_findings": [f.to_json() for f in new],
    }
    if audit_checks is not None:
        rep["audit"] = [c.to_json() for c in audit_checks]
        rep["counts"]["audit_failures"] = sum(
            c.status == "fail" for c in audit_checks)
    return rep


def load_baseline(path: str) -> Optional[Dict]:
    if not os.path.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)


def new_findings(findings: List[Finding],
                 baseline: Optional[Dict]) -> List[Finding]:
    """Active findings whose fingerprint is not in the baseline.
    Fingerprints are line-number-free (rule|path|normalized snippet), so
    unrelated edits above a known finding don't resurface it."""
    active = [f for f in findings if not f.suppressed]
    if not baseline:
        return active
    known = {f.get("fingerprint") for f in baseline.get("findings", [])}
    return [f for f in active if f.fingerprint not in known]
