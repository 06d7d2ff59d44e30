"""Paper Table 2 (structural reproduction): asymmetric key/value retention
under a fixed budget (TopK_R + TopV_R = 1), zero buffer.

Paper shape: symmetric 0.5/0.5 best; extreme asymmetry catastrophic.

What the rows vary: the serve path applies one per-layer runtime
retention, ``k_key``, to the key AND the value winnow (the reference's
behaviour, kept on purpose), so ``k_value`` has no effect and this sweep
measures key retention only.  With ``buffer=0`` the decode kernel is not
eligible: the plain path reads the cache, on the card too.

    python -m repro_torch.benchmarks.bench_table2_kv_split [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from repro_torch.benchmarks.common import (bench_record, emit, eval_tokens,
                                           swan_teacher_forced_nll,
                                           trained_tiny_lm)
from repro_torch.configs import SwanConfig
from repro_torch.device import DeviceLike, resolve_device

SPLITS = [(0.2, 0.8), (0.35, 0.65), (0.5, 0.5), (0.65, 0.35), (0.8, 0.2)]


def _run(dev) -> None:
    cfg, params, pj, absorbed = trained_tiny_lm(dev)
    tokens = eval_tokens(cfg, device=dev)
    for kr, vr in SPLITS:
        kk = max(int(round(cfg.d_head * kr)), 1)
        kv = max(int(round(cfg.d_head * vr)), 1)
        swan = SwanConfig(k_max=max(kk, kv), buffer=0, mode="topk",
                          k_key=kk, k_value=kv)
        t0 = time.perf_counter()
        nll = swan_teacher_forced_nll(cfg, absorbed, tokens, swan, pj)
        emit("table2_kv_split", (time.perf_counter() - t0) * 1e6,
             f"topk_r={kr:.2f}_topv_r={vr:.2f}_nll={nll:.4f}")


def run(device: DeviceLike = None):
    dev = resolve_device(device)
    with bench_record("table2_kv_split_torch", dev) as rec:
        _run(dev)
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    run(ap.parse_args().device)
