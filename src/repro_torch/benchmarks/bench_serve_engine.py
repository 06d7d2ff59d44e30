"""Continuous-batching serve engine under a Poisson arrival trace (port of
``benchmarks/bench_serve_engine.py``).

Replays a deterministic Poisson request trace (exponential inter-arrivals,
in engine-step units) through ``repro_torch.runtime.serve_engine.
ServeEngine`` with mixed prompt lengths and, on the SWAN run, mixed
per-request compression levels k (all levels share one decode graph).
Reports tokens per second and physical KV-cache bytes (paper Eq. 1) for
dense vs SWAN serving of the same trace, and gates that mixed k needs one
decode graph (none on an eager engine).

    python -m repro_torch.benchmarks.bench_serve_engine [--smoke] [--device cpu]

``--smoke`` runs the reference's own trace on its tiny float32 model; the
default runs llama3-8b at full width in bf16 on the card, with the
trace's prompt lengths and k scaled by 64 and 8 (``SwanConfig(k_max=64,
buffer=128)``, max_seq 4096).  On the card every dispatch replays a CUDA
graph, and the engines start unwarmed: the time includes each bucket's
capture at first use (``captures=`` in the row, from the engine's
``serve_compile_total``).  ``BENCH_serve_engine_torch.json`` lands in
``$REPRO_BENCH_OUT`` (default ``bench_out/``) with both engines' metrics.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.benchmarks.common import (bench_record, emit, gate,
                                           record_metrics, serve_model)
from repro_torch.configs import SwanConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.io import make_batch
from repro_torch.runtime.serve_engine import Request, ServeEngine

N_REQUESTS = 4
N_SLOTS = 2          # < N_REQUESTS: the queue + backfill path is exercised
GEN_TOKENS = 24
ARRIVAL_RATE = 0.25  # requests per engine step (Poisson)


@dataclass(frozen=True)
class Sizes:
    max_seq: int
    prompts: Tuple[int, ...]
    k_cycle: Tuple[int, ...]
    swan: SwanConfig


def sizes(smoke: bool) -> Sizes:
    if smoke:       # the reference bench's own
        return Sizes(128, (8, 20, 12, 28), (8, 4),
                     SwanConfig(k_max=8, buffer=8, mode="topk"))
    return Sizes(4096, (512, 1280, 768, 1792), (64, 32),
                 SwanConfig(k_max=64, buffer=128, mode="topk"))


def _trace(cfg, sz: Sizes, k_cycle):
    """Deterministic Poisson trace: mixed prompt lengths, cycled k."""
    rng = np.random.default_rng(0)
    arrivals = np.floor(np.cumsum(
        rng.exponential(1.0 / ARRIVAL_RATE, N_REQUESTS))).astype(int)
    reqs = []
    for i in range(N_REQUESTS):
        plen = sz.prompts[i % 4]
        toks = make_batch(cfg, 1, plen, seed=200 + i, device="cpu")["tokens"][0]
        reqs.append(Request(
            uid=f"req{i}", tokens=toks.tolist(),
            max_new_tokens=GEN_TOKENS, arrival_step=int(arrivals[i]),
            k=k_cycle[i % len(k_cycle)]))
    return reqs


def _bench(tag, engine, reqs):
    dev = engine.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    comps = engine.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n_tok = sum(len(c.tokens) for c in comps)
    if len(comps) != N_REQUESTS:
        raise RuntimeError(f"{tag}: {len(comps)} of {N_REQUESTS} requests "
                           "completed")
    rep = engine.cache_report()
    ks = sorted({str(c.k) for c in comps})
    captures = sum(s["value"] for s in engine.metrics.snapshot()["metrics"]
                   .get("serve_compile_total", {"series": []})["series"])
    emit(f"serve_engine_{tag}", dt / n_tok * 1e6,
         f"tok_s={n_tok / dt:.1f};cache_bytes={rep['bytes']};"
         f"reqs={len(comps)};steps={engine.step_count};k_levels={'|'.join(ks)}"
         + (f";saving={rep['saving']:.2f}" if "saving" in rep else "")
         + f";captures={captures}")
    record_metrics(engine.metrics, tag)


def run(smoke: bool = False, device: DeviceLike = None) -> None:
    dev = resolve_device(device)
    sz = sizes(smoke)
    with bench_record("serve_engine_torch", dev) as rec:
        rec.extra["smoke"] = smoke
        cfg, params, pj, absorbed = serve_model(smoke, dev)
        dense = ServeEngine(cfg, params, max_seq=sz.max_seq, n_slots=N_SLOTS,
                            device=dev)
        _bench("dense", dense, _trace(cfg, sz, [None]))
        del dense
        eng = ServeEngine(cfg, absorbed, swan=sz.swan, projections=pj,
                          max_seq=sz.max_seq, n_slots=N_SLOTS, device=dev)
        # two distinct per-request compression levels in one trace
        _bench("swan_mixed_k", eng, _trace(cfg, sz, sz.k_cycle))
        want = 1 if dev.type == "cuda" else 0
        gate("mixed_k_one_executable", eng.decode_cache_size == want,
             f"mixed k must share one decode graph ({eng.decode_cache_size} "
             f"held, {want} expected on {dev.type})")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's trace on its tiny float32 model")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    run(smoke=args.smoke, device=args.device)
