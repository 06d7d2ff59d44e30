"""Paper Eq. 2 / Appendix A.2: computational break-even point (port of
``benchmarks/bench_breakeven.py``).

Validates the analytical break-even length against the first length at
which the counted FLOP models cross (attention only, per head), and emits
the long-context FLOP ratio.  Pure arithmetic: no device runs anything.

    python -m repro_torch.benchmarks.bench_breakeven
"""
from __future__ import annotations

import time

import torch

from repro_torch.benchmarks.common import bench_record, emit, gate
from repro_torch.core.analytical import (breakeven_length, flops_standard,
                                         flops_swan)


def _crossing(dh, k, b, lo=1, hi=1 << 20):
    """First L where the counted models cross (binary search)."""
    while lo < hi:
        mid = (lo + hi) // 2
        if flops_swan(mid, dh, k, b) < flops_standard(mid, dh):
            hi = mid
        else:
            lo = mid + 1
    return lo


def _run() -> None:
    dh = 128
    for b in (0, 128):
        for k in (32, 64, 96):
            t0 = time.perf_counter()
            analytic = breakeven_length(dh, k, b)
            counted = _crossing(dh, k, b)
            us = (time.perf_counter() - t0) * 1e6
            ok = abs(counted - analytic) <= 2
            emit("eq2_breakeven", us,
                 f"dh={dh}_k={k}_b={b}_analytic={analytic:.1f}"
                 f"_counted={counted}_match={'yes' if ok else 'NO'}")
            gate(f"eq2_match_k{k}_b{b}", ok,
                 f"counted crossing {counted} vs analytic {analytic:.1f}")
    # savings at long context (the paper's motivating regime)
    L = 32_768
    for k in (32, 64):
        ratio = flops_swan(L, dh, k, 128) / flops_standard(L, dh)
        emit("eq2_longctx_flop_ratio", 0.0, f"L=32768_k={k}_swan/std={ratio:.3f}")


def run():
    """Emit the rows; returns the recorder (rows and gates)."""
    with bench_record("breakeven_torch", torch.device("cpu")) as rec:
        _run()
    return rec


if __name__ == "__main__":
    run()
