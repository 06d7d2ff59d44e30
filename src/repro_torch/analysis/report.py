"""Dry-run and roofline tables from the port's step records (port of
``repro/analysis/report.py``).

    PYTHONPATH=src python -m repro_torch.analysis.report <dir of *.json>

A record is one JSON object per (arch, shape): ``arch``, ``shape``,
``swan``, ``status`` ("ok", "skipped" or "error"), ``n_devices``,
``step_cost`` (:class:`~repro_torch.analysis.cost.StepCosts` fields, the
reference's ``hlo_cost``) and ``roofline``
(:func:`~repro_torch.analysis.roofline.roofline_report`).  A record of a
step measured on the card also holds ``measured``: ``step_ms`` (the
graphed step) and ``device`` (the card's name and power limit as
nvidia-smi prints them); the table then adds the analyzer's flops and
bytes, the step time and the model FLOPs' share of the card's peak over
that time.  A dry-run record (``launch.dryrun``) also holds
``multi_pod``, ``memory`` (per-device argument, output, temp and alias
bytes) and ``replicated_ops``; :func:`dryrun_table` reads those.
"""
from __future__ import annotations

import glob
import json
import os
import sys
from typing import Dict, List

from repro_torch.analysis.roofline import PEAK_FLOPS


def load_records(d: str) -> List[Dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(f, "r", encoding="utf-8") as fh:
            out.append(json.load(fh))
    return out


def _fmt_bytes(b: float) -> str:
    if b >= 1e12:
        return f"{b / 1e12:.2f}TB"
    if b >= 1e9:
        return f"{b / 1e9:.2f}GB"
    return f"{b / 1e6:.1f}MB"


def _fmt_s(x: float) -> str:
    return f"{x:.2e}"


def dryrun_table(recs: List[Dict]) -> str:
    """The reference's dry-run table, per device, from ``step_cost``."""
    lines = ["| arch | shape | mesh | swan | status | per-dev args | per-dev temps | coll bytes/dev | collectives |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        mesh = "2x16x16" if r.get("multi_pod") else "16x16"
        sw = "on" if r["swan"] else "—"
        if r["status"] != "ok":
            reason = r.get("reason", r.get("error", ""))[:60]
            lines.append(f"| {r['arch']} | {r['shape']} | {mesh} | {sw} | "
                         f"{r['status']}: {reason} | | | | |")
            continue
        m = r["memory"]
        h = r["step_cost"]
        per = ", ".join(f"{k}:{_fmt_bytes(v)}"
                        for k, v in sorted(h["per_collective"].items()))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {mesh} | {sw} | ok | "
            f"{_fmt_bytes(m['argument_bytes'])} | {_fmt_bytes(m['temp_bytes'])} | "
            f"{_fmt_bytes(h['collective_bytes'])} | {per} |")
    return "\n".join(lines)


def measured_share(rec: Dict) -> float:
    """Model FLOPs over the measured step time, as a share of
    ``PEAK_FLOPS`` per device."""
    m = rec["measured"]
    return (rec["roofline"]["model_flops"]
            / (m["step_ms"] * 1e-3 * rec.get("n_devices", 1) * PEAK_FLOPS))


def roofline_table(recs: List[Dict]) -> str:
    measured = any("measured" in r for r in recs)
    head = ("| arch | shape | swan | compute_s | memory_s | collective_s | "
            "bottleneck | MODEL_FLOPS | useful ratio | roofline frac |")
    rule = "|---|---|---|---|---|---|---|---|---|---|"
    if measured:
        head += (" step flops | step bytes | step ms | MODEL_FLOPS share "
                 f"of {PEAK_FLOPS / 1e12:.0f} TFLOP/s | device |")
        rule += "---|---|---|---|---|"
    lines = [head, rule]
    for r in recs:
        if r["status"] != "ok" or r.get("multi_pod"):
            continue
        ro = r["roofline"]
        sw = "on" if r["swan"] else "—"
        row = (f"| {r['arch']} | {r['shape']} | {sw} | "
               f"{_fmt_s(ro['compute_s'])} | {_fmt_s(ro['memory_s'])} | "
               f"{_fmt_s(ro['collective_s'])} | **{ro['bottleneck']}** | "
               f"{ro['model_flops']:.2e} | {ro['useful_flops_ratio']:.2f} | "
               f"{ro['roofline_fraction']:.4f} |")
        if measured:
            m = r.get("measured")
            if m is None:
                row += " | | | | |"
            else:
                c = r["step_cost"]
                row += (f" {c['flops']:.4e} | {c['hbm_bytes']:.4e} | "
                        f"{m['step_ms']:.3f} | {measured_share(r):.2%} | "
                        f"{m['device']} |")
        lines.append(row)
    return "\n".join(lines)


def summary_stats(recs: List[Dict]) -> str:
    ok = [r for r in recs if r["status"] == "ok"]
    skipped = [r for r in recs if r["status"] == "skipped"]
    errs = [r for r in recs if r["status"] == "error"]
    doms: Dict[str, int] = {}
    for r in ok:
        if not r.get("multi_pod"):
            d = r["roofline"]["bottleneck"]
            doms[d] = doms.get(d, 0) + 1
    out = [f"- compiled OK: **{len(ok)}** cells "
           f"({sum(1 for r in ok if r.get('multi_pod'))} multi-pod, "
           f"{sum(1 for r in ok if r['swan'])} SWAN variants)",
           f"- skipped by §Arch-applicability: {len(skipped)}",
           f"- errors: {len(errs)}",
           f"- single-pod bottleneck mix: {doms}"]
    return "\n".join(out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m repro_torch.analysis.report <dir of *.json>",
              file=sys.stderr)
        return 2
    recs = load_records(argv[0])
    print("## Dry-run summary\n")
    print(summary_stats(recs))
    dry = [r for r in recs if "memory" in r or r["status"] != "ok"]
    if dry:
        print("\n## Dry-run table\n")
        print(dryrun_table(dry))
    print("\n## Roofline table (per-device terms, NVIDIA H100 SXM)\n")
    print(roofline_table(recs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
