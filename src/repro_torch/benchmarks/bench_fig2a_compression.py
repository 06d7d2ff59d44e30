"""Paper Fig. 2a: compression-vs-pruning trade-off (exact analytical; port
of ``benchmarks/bench_fig2a_compression.py``).

Emits the retention-ratio -> effective-compression curve for 16-bit and
8-bit sparse values, plus the break-even retention thresholds the figure
highlights (0.66 for fp16, ~1.0 for 8-bit).  Pure arithmetic: no device
runs anything.

    python -m repro_torch.benchmarks.bench_fig2a_compression
"""
from __future__ import annotations

import time

import torch

from repro_torch.benchmarks.common import bench_record, emit
from repro_torch.core.analytical import (compression_ratio,
                                         memory_breakeven_retention)


def _run() -> None:
    d_head = 128
    t0 = time.perf_counter()
    rows = []
    for pct in range(5, 105, 5):
        k = max(int(d_head * pct / 100), 1)
        rows.append((pct / 100, compression_ratio(k, d_head, False),
                     compression_ratio(k, d_head, True)))
    us = (time.perf_counter() - t0) * 1e6
    be16 = memory_breakeven_retention(d_head)
    be8 = memory_breakeven_retention(d_head, bits8=True)
    emit("fig2a_breakeven_fp16", us, f"retention<{be16:.3f}_saves_memory")
    emit("fig2a_breakeven_int8", us, f"retention<{be8:.3f}_saves_memory")
    for r, c16, c8 in rows:
        emit("fig2a_curve", us / len(rows),
             f"retention={r:.2f}_fp16={c16:.3f}_int8={c8:.3f}")


def run():
    """Emit the rows; returns the recorder (rows and gates)."""
    with bench_record("fig2a_compression_torch", torch.device("cpu")) as rec:
        _run()
    return rec


if __name__ == "__main__":
    run()
