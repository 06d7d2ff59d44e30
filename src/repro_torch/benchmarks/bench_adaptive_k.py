"""Beyond-paper extension: adaptive per-layer retention
(``repro_torch.core.adaptive``).

Same global retention budget, two allocations:
  * uniform  — the paper's single k for every layer,
  * adaptive — water-filled from each layer's calibration spectrum.

Uses the runtime-tunability mechanism (per-layer k_active ≤ k_max), so the
physical allocation is identical — only quality differs.

    python -m repro_torch.benchmarks.bench_adaptive_k [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.benchmarks.common import (bench_record, emit, eval_tokens,
                                           swan_teacher_forced_nll,
                                           trained_tiny_lm)
from repro_torch.configs import SwanConfig
from repro_torch.core.adaptive import allocate_k, spectra_from_joint
from repro_torch.device import DeviceLike, resolve_device


def _run(dev) -> None:
    cfg, params, pj, absorbed = trained_tiny_lm(dev)
    tokens = eval_tokens(cfg, device=dev)
    spec = spectra_from_joint(pj["spectrum_qk"])
    for avg_k in [8, 4]:
        swan = SwanConfig(k_max=cfg.d_head, buffer=8, mode="topk",
                          k_key=avg_k, k_value=avg_k)
        t0 = time.perf_counter()
        nll_u = swan_teacher_forced_nll(cfg, absorbed, tokens, swan, pj)
        us = (time.perf_counter() - t0) * 1e6
        k_ad = allocate_k(spec, avg_k, k_min=max(avg_k // 2, 1),
                          k_max=min(2 * avg_k, cfg.d_head))
        pj_ad = dict(pj)
        pj_ad["k_layer"] = torch.as_tensor(k_ad)
        t0 = time.perf_counter()
        nll_a = swan_teacher_forced_nll(cfg, absorbed, tokens, swan, pj_ad)
        us_a = (time.perf_counter() - t0) * 1e6
        emit("adaptive_k", us,
             f"avg_k={avg_k}_uniform_nll={nll_u:.4f}")
        emit("adaptive_k", us_a,
             f"avg_k={avg_k}_adaptive_nll={nll_a:.4f}_alloc={list(k_ad)}"
             f"_delta={nll_a - nll_u:+.4f}")


def run(device: DeviceLike = None):
    dev = resolve_device(device)
    with bench_record("adaptive_k_torch", dev) as rec:
        _run(dev)
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    run(ap.parse_args().device)
