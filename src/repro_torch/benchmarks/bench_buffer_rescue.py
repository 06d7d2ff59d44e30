"""Paper Fig. 2b / Fig. 3 (structural reproduction): the dense-buffer
rescue.  Quality vs retention for bt=0 vs bt=8 vs bt=8+int8.

Paper shape: zero-buffer variants collapse; buffered variants degrade
gracefully.  With d_head=32 (vs the paper's 128) the collapse region sits
at deeper retention ratios (~0.1 vs the paper's ~0.3); the sweep covers
the crossover.  On the card the buffered variants' decode reads go through
the decode kernel (f32 and int8 values), the bt0 ones through the plain
path.

    python -m repro_torch.benchmarks.bench_buffer_rescue [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from repro_torch.benchmarks.common import (bench_record, emit, eval_tokens,
                                           swan_teacher_forced_nll,
                                           trained_tiny_lm)
from repro_torch.configs import SwanConfig
from repro_torch.device import DeviceLike, resolve_device

RATIOS = [0.5, 0.19, 0.09, 0.06]
VARIANTS = [("bt0_fp", 0, False), ("bt8_fp", 8, False), ("bt8_int8", 8, True)]


def _run(dev) -> None:
    cfg, params, pj, absorbed = trained_tiny_lm(dev)
    tokens = eval_tokens(cfg, device=dev)
    for ratio in RATIOS:
        k = max(int(round(cfg.d_head * ratio)), 1)
        for name, bt, q8 in VARIANTS:
            swan = SwanConfig(k_max=k, buffer=bt, mode="topk", quantize=q8)
            t0 = time.perf_counter()
            nll = swan_teacher_forced_nll(cfg, absorbed, tokens, swan, pj)
            emit("fig2b_buffer_rescue", (time.perf_counter() - t0) * 1e6,
                 f"ratio={ratio:.2f}_{name}_nll={nll:.4f}")


def run(device: DeviceLike = None):
    dev = resolve_device(device)
    with bench_record("buffer_rescue_torch", dev) as rec:
        _run(dev)
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    run(ap.parse_args().device)
