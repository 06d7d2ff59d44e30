"""Paper Table 1 (structural reproduction): quality vs top-k retention
ratio on the trained tiny LM, scored through the SWAN serving path (on the
card, the decode kernel reads the buffered hybrid cache).

Paper shape to reproduce: ~flat through ratio 0.75, mild loss at 0.5,
collapse at 0.3.

    python -m repro_torch.benchmarks.bench_table1_retention [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from repro_torch.benchmarks.common import (bench_record, emit, eval_tokens,
                                           swan_teacher_forced_nll,
                                           trained_tiny_lm)
from repro_torch.configs import SwanConfig
from repro_torch.device import DeviceLike, resolve_device

RATIOS = [1.0, 0.9, 0.75, 0.5, 0.3, 0.1]


def _run(dev) -> None:
    cfg, params, pj, absorbed = trained_tiny_lm(dev)
    tokens = eval_tokens(cfg, device=dev)
    t0 = time.perf_counter()
    base = swan_teacher_forced_nll(cfg, params, tokens, None)
    emit("table1_retention_baseline", (time.perf_counter() - t0) * 1e6,
         f"ratio=1.00_nll={base:.4f}")
    for ratio in RATIOS:
        k = max(int(round(cfg.d_head * ratio)), 1)
        swan = SwanConfig(k_max=k, buffer=8, mode="topk")
        t0 = time.perf_counter()
        nll = swan_teacher_forced_nll(cfg, absorbed, tokens, swan, pj)
        emit("table1_retention", (time.perf_counter() - t0) * 1e6,
             f"ratio={ratio:.2f}_k={k}_nll={nll:.4f}_delta={nll - base:+.4f}")


def run(device: DeviceLike = None):
    dev = resolve_device(device)
    with bench_record("table1_retention_torch", dev) as rec:
        _run(dev)
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    run(ap.parse_args().device)
