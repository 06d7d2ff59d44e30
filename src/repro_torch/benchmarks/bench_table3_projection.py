"""Paper Table 3 (structural reproduction): projection-specificity ablation
at 50% retention — our data-driven joint-SVD basis vs Random / Layer-Shuffle
/ KV-Swap / Head-Shuffle variants.

Paper shape: Ours > shuffles > random.  The random bases and the
permutations are drawn from a ``torch.Generator`` seeded 42: the same law
as the reference's draws, not the same draws, so those rows are the port's
own.  Zero buffer: the plain path reads the cache, on the card too.

    python -m repro_torch.benchmarks.bench_table3_projection [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.benchmarks.common import (bench_record, emit, eval_tokens,
                                           swan_teacher_forced_nll,
                                           trained_tiny_lm)
from repro_torch.configs import SwanConfig
from repro_torch.core.projections import random_orthogonal
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.registry import get_model


def _variants(pj):
    dev = pj["p_qk"].device
    gen = torch.Generator(device=dev).manual_seed(42)
    L, Kv, dh, _ = pj["p_qk"].shape
    yield "ours", pj
    yield "random", {"p_qk": random_orthogonal(gen, (L, Kv), dh),
                     "p_vo": random_orthogonal(gen, (L, Kv), dh)}
    perm_l = torch.randperm(L, generator=gen, device=dev)
    yield "layer_shuffle", {"p_qk": pj["p_qk"][perm_l],
                            "p_vo": pj["p_vo"][perm_l]}
    yield "kv_swap", {"p_qk": pj["p_vo"], "p_vo": pj["p_qk"]}
    perm_h = torch.randperm(Kv, generator=gen, device=dev)
    yield "head_shuffle", {"p_qk": pj["p_qk"][:, perm_h],
                           "p_vo": pj["p_vo"][:, perm_h]}


def _run(dev) -> None:
    cfg, params, pj, _ = trained_tiny_lm(dev)
    api = get_model(cfg)
    tokens = eval_tokens(cfg, device=dev)
    swan = SwanConfig(k_max=cfg.d_head // 2, buffer=0, mode="topk")
    results = {}
    for name, pjv in _variants(pj):
        absorbed_v = api.absorb(params, cfg, pjv)
        t0 = time.perf_counter()
        nll = swan_teacher_forced_nll(cfg, absorbed_v, tokens, swan, pjv)
        results[name] = nll
        emit("table3_projection", (time.perf_counter() - t0) * 1e6,
             f"variant={name}_nll={nll:.4f}")
    ok = results["ours"] <= min(v for k, v in results.items()
                                if k != "ours") + 1e-3
    emit("table3_projection_check", 0.0,
         f"ours_best={'yes' if ok else 'NO'}")


def run(device: DeviceLike = None):
    dev = resolve_device(device)
    with bench_record("table3_projection_torch", dev) as rec:
        _run(dev)
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    run(ap.parse_args().device)
