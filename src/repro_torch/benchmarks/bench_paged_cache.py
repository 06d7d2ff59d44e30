"""Paged sparse KV cache under the Poisson serve trace: memory follows live
tokens (port of ``benchmarks/bench_paged_cache.py``).

Replays the deterministic Poisson request trace (mixed prompt lengths,
mixed per-request SWAN k) through two engines over the SAME requests:

  * slab   — every slot reserves ``max_seq`` sparse rows up front
             (reserved == live at all times, by construction);
  * paged  — slots share a page pool (``repro_torch.core.paged_cache``);
             pages are mapped as winnowed tokens land and reclaimed the
             step a sequence retires.

Live cache bytes are read after every engine step off the engine's
``kv_cache_live_bytes`` gauge (the same source as ``cache_report()``).
The reference's gates: the paged engine is token-identical to the slab
engine; the slab reports reserved == live; the last gauge reading equals
``cache_report()``; peak live bytes stay under the slab layout; live
bytes grow with generated tokens and drop on retirement; a drained pool
holds no live page.

    python -m repro_torch.benchmarks.bench_paged_cache [--smoke] [--device cpu]

``--smoke`` runs the reference's own small trace on its tiny float32
model; the default runs llama3-8b at full width in bf16 on the card, with
prompt lengths, k and page size scaled (``SwanConfig(k_max=64,
buffer=128)``, 64-token pages, max_seq 4096; engines start unwarmed, so
the time includes each graph's capture).  ``BENCH_paged_cache_torch.json``
lands in ``$REPRO_BENCH_OUT`` (default ``bench_out/``) with the paged
engine's metrics.
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

N_SLOTS = 2          # < n_requests: the queue + backfill path is exercised
ARRIVAL_RATE = 0.25  # requests per engine step (Poisson)


@dataclass(frozen=True)
class Sizes:
    max_seq: int
    page_size: int
    prompts: Tuple[int, ...]
    k_cycle: Tuple[int, ...]
    swan: SwanConfig


def sizes(smoke: bool) -> Sizes:
    if smoke:       # the reference bench's own
        return Sizes(128, 16, (8, 20, 12, 28), (8, 4),
                     SwanConfig(k_max=8, buffer=8, mode="topk"))
    return Sizes(4096, 64, (512, 1280, 768, 1792), (64, 32),
                 SwanConfig(k_max=64, buffer=128, mode="topk"))


def _trace(cfg, sz: Sizes, n_requests, gen_tokens):
    """Deterministic Poisson trace: mixed prompt lengths, mixed k."""
    rng = np.random.default_rng(0)
    arrivals = np.floor(np.cumsum(
        rng.exponential(1.0 / ARRIVAL_RATE, n_requests))).astype(int)
    reqs = []
    for i in range(n_requests):
        plen = sz.prompts[i % 4]
        toks = make_batch(cfg, 1, plen, seed=200 + i, device="cpu")["tokens"][0]
        reqs.append(Request(
            uid=f"req{i}", tokens=toks.tolist(),
            max_new_tokens=gen_tokens, arrival_step=int(arrivals[i]),
            k=sz.k_cycle[i % 2]))
    return reqs


def _drain_sampling(engine, reqs):
    """Run the trace step by step, reading live bytes off the
    ``kv_cache_live_bytes`` gauge the engine sets after every step."""
    for r in reqs:
        engine.submit(r)
    live_series, retired_at = [], []
    t0 = time.perf_counter()
    while not engine.done:
        n_ret = engine.step()
        live_series.append(int(engine.metrics.value("kv_cache_live_bytes")))
        if n_ret:
            retired_at.append(len(live_series) - 1)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return time.perf_counter() - t0, live_series, retired_at


def run(smoke: bool = False, device: DeviceLike = None) -> None:
    dev = resolve_device(device)
    sz = sizes(smoke)
    n_requests, gen_tokens = (4, 12) if smoke else (6, 24)
    with bench_record("paged_cache_torch", dev) as rec:
        rec.extra["smoke"] = smoke
        cfg, _, pj, absorbed = serve_model(smoke, dev)
        slab = ServeEngine(cfg, absorbed, swan=sz.swan, projections=pj,
                           max_seq=sz.max_seq, n_slots=N_SLOTS, device=dev)
        want = {c.uid: c.tokens for c in slab.run(
            _trace(cfg, sz, n_requests, gen_tokens))}
        slab_rep = slab.cache_report()
        del slab

        paged = ServeEngine(cfg, absorbed, swan=sz.swan, projections=pj,
                            max_seq=sz.max_seq, n_slots=N_SLOTS, paged=True,
                            page_size=sz.page_size, device=dev)
        dt, live, retired_at = _drain_sampling(
            paged, _trace(cfg, sz, n_requests, gen_tokens))
        got = {c.uid: c.tokens for c in paged.completions}

        # --- acceptance gates (the reference's) --------------------------
        gate("token_identity", got == want,
             "paged engine diverged from slab engine")
        rep = paged.cache_report()
        gate("slab_reserved_eq_live",
             slab_rep["reserved_bytes"] == slab_rep["live_bytes"],
             f"{slab_rep['reserved_bytes']} != {slab_rep['live_bytes']}")
        # the gauge and cache_report() read the same _cache_bytes() source
        gate("gauge_matches_report", live[-1] == rep["live_bytes"],
             f"gauge {live[-1]} != report {rep['live_bytes']}")
        peak = max(live)
        gate("peak_under_slab", peak < rep["slab_bytes"],
             f"live bytes {peak} should undercut slab {rep['slab_bytes']}")
        # memory must TRACK tokens: growing while sequences only decode
        grow = live[:retired_at[0]]
        gate("live_bytes_grow",
             any(b2 > b1 for b1, b2 in zip(grow, grow[1:])),
             "live bytes never grew with generated tokens")
        # retirement reclaims pages: some later sample dips below the peak
        gate("retirement_reclaims", min(live[retired_at[0]:]) < peak,
             "no pages reclaimed on retirement")
        gate("pool_drained", rep["live_pages"] == 0,
             "pages leaked after drain")
        paged.pool.check_consistent()

        n_tok = sum(len(t) for t in got.values())
        emit("paged_cache_poisson", dt / n_tok * 1e6,
             f"tok_s={n_tok / dt:.1f};reqs={len(got)};"
             f"steps={paged.step_count};peak_live_bytes={peak};"
             f"slab_bytes={rep['slab_bytes']};"
             f"reserved_bytes={rep['reserved_bytes']};"
             f"page_size={sz.page_size};"
             f"prefill_execs={paged.prefill_cache_size}")
        emit("paged_cache_reclaim", 0.0,
             f"live_series_head={'|'.join(str(b) for b in live[:6])};"
             f"retired_steps={len(retired_at)};final_live_pages=0")
        record_metrics(paged.metrics, "paged")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's small trace on its tiny model")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    run(smoke=args.smoke, device=args.device)
