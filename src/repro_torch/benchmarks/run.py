"""Benchmark harness of the port (port of ``benchmarks/run.py``): one
module per paper table or figure, the reference harness's 13 modules in
its order.

    python -m repro_torch.benchmarks.run                      # the card
    python -m repro_torch.benchmarks.run --smoke --device cpu

It prints ``name,us_per_call,derived`` CSV rows.  The quality benchmarks
score a tiny LM trained in process (``common.trained_tiny_lm``, cached on
disk); ``--smoke`` gives the serve and kernel benches their small shapes
and ``--device cpu`` runs every bench's plain path (the warmup bench needs
CUDA graphs and fails there).  Each module writes ``BENCH_<name>_torch.json``
into ``$REPRO_BENCH_OUT`` (default ``bench_out/``, shared with the
reference's artifacts); :func:`aggregate` folds the port's artifacts alone
into ``BENCH_SUMMARY_torch.json``, with the reference summary's fields, and
never reads the reference's artifacts or writes its ``BENCH_SUMMARY.json``.
It exits 1 when any module failed.
"""
from __future__ import annotations

import argparse
import glob
import inspect
import json
import os
import sys
import time
import traceback

from repro_torch.benchmarks import (bench_adaptive_k, bench_breakeven,
                                    bench_buffer_rescue,
                                    bench_fig2a_compression, bench_kernels,
                                    bench_longcontext_error,
                                    bench_memory_footprint, bench_paged_cache,
                                    bench_serve_engine,
                                    bench_table1_retention,
                                    bench_table2_kv_split,
                                    bench_table3_projection, bench_warmup)
from repro_torch.benchmarks.common import bench_out_dir

MODULES = [
    ("fig2a_compression", bench_fig2a_compression),
    ("eq2_breakeven", bench_breakeven),
    ("memory_footprint", bench_memory_footprint),
    ("table1_retention", bench_table1_retention),
    ("table2_kv_split", bench_table2_kv_split),
    ("table3_projection", bench_table3_projection),
    ("fig2b_buffer_rescue", bench_buffer_rescue),
    ("fig4_longcontext", bench_longcontext_error),
    ("adaptive_k", bench_adaptive_k),          # beyond-paper extension
    ("serve_engine", bench_serve_engine),      # continuous batching
    ("paged_cache", bench_paged_cache),        # memory follows live tokens
    ("warmup", bench_warmup),                  # graph-family warmup
    ("kernels", bench_kernels),
]

SUMMARY = "BENCH_SUMMARY_torch.json"


def aggregate() -> dict:
    """Fold every ``BENCH_*_torch.json`` artifact in the output dir into
    ``BENCH_SUMMARY_torch.json`` (per bench: ok, rows, gates; the gate
    tally), the reference summary's fields."""
    outdir = bench_out_dir()
    benches = {}
    for path in sorted(glob.glob(os.path.join(outdir, "BENCH_*_torch.json"))):
        if os.path.basename(path) == SUMMARY:
            continue
        try:
            with open(path) as fh:
                art = json.load(fh)
        except (OSError, ValueError) as e:
            print(f"# skipping unreadable artifact {path}: {e}",
                  file=sys.stderr)
            continue
        benches[art.get("bench", os.path.basename(path))] = {
            "ok": art.get("ok", False),
            "jax_version": art.get("jax_version"),
            "n_rows": len(art.get("rows", [])),
            "gates": {g["name"]: g["passed"] for g in art.get("gates", [])},
        }
    summary = {
        "benches": benches,
        "n_benches": len(benches),
        "n_gates": sum(len(b["gates"]) for b in benches.values()),
        "gates_failed": sorted(
            f"{name}:{g}" for name, b in benches.items()
            for g, passed in b["gates"].items() if not passed),
        "all_ok": all(b["ok"] for b in benches.values()),
    }
    if benches:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, SUMMARY), "w") as fh:
            json.dump(summary, fh, indent=2, sort_keys=True)
    return summary


def _run(mod, smoke: bool, device) -> None:
    """``mod.run`` with the arguments it takes of ``smoke`` and
    ``device`` (the analytical benches take neither)."""
    params = inspect.signature(mod.run).parameters
    kw = {}
    if "smoke" in params:
        kw["smoke"] = smoke
    if "device" in params:
        kw["device"] = device
    mod.run(**kw)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks.run")
    ap.add_argument("--smoke", action="store_true",
                    help="the serve and kernel benches at their small shapes")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    failures = 0
    for name, mod in MODULES:
        t0 = time.monotonic()
        try:
            _run(mod, args.smoke, args.device)
            print(f"# [{name}] ok in {time.monotonic() - t0:.1f}s",
                  file=sys.stderr)
        except Exception:
            failures += 1
            print(f"# [{name}] FAILED", file=sys.stderr)
            traceback.print_exc()
    summary = aggregate()
    print(f"# {summary['n_benches']} artifacts, {summary['n_gates']} gates "
          f"({len(summary['gates_failed'])} failed) -> "
          f"{os.path.join(bench_out_dir(), SUMMARY)}", file=sys.stderr)
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
