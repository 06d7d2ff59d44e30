"""Graph-family warmup: cold vs warm TTFT, zero steady-state captures (port
of ``benchmarks/bench_warmup.py``).

Exercises ``repro_torch.runtime.warmup`` end to end on the serve engine,
with the reference's gates, counted in CUDA-graph captures
(``repro_torch.obs.compile_events``) where the reference counts XLA
compiles:

* **cold vs warm TTFT** — the first request on a cold engine pays the
  capture of each bucket its chunks and decode reach; after
  ``ServeEngine.warmup()`` the whole family is captured, so the warm
  first-request TTFT must come in at <= 0.5x the cold one;
* **zero steady-state captures** — after warmup a randomized mixed
  workload (mixed prompt lengths, per-request k, greedy and temperature
  lanes) captures NO graph: the process-global capture count and
  ``executable_census()`` stay put, on the slab and the paged engine;
* **warmup idempotency** — a second ``warmup()`` captures nothing;
* **async fetch identity** — ``async_fetch=True`` gives the synchronous
  path's tokens, admission/first-token/finish steps and dispatch counts.

Warmup captures CUDA graphs, so the bench needs the card: on the CPU it
raises, as ``warmup()`` does on an eager engine (the CPU tests run it
through an emulated graph set).

    python -m repro_torch.benchmarks.bench_warmup [--smoke]

``--smoke`` runs the reference's smoke family on its tiny float32 model;
the default runs llama3-8b at full width in bf16 with
``SwanConfig(k_max=64, buffer=128)``, max_seq 512, 32-token chunks and
prompts of up to 256 tokens (a family of 79 graphs on the slab and 52
paged).  ``BENCH_warmup_torch.json`` lands in ``$REPRO_BENCH_OUT``
(default ``bench_out/``) with the warmed slab engine's metrics.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.benchmarks.common import (bench_record, emit, gate,
                                           record_metrics, serve_model)
from repro_torch.configs import SwanConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.io import make_batch
from repro_torch.obs import compile_events
from repro_torch.runtime.serve_engine import Request, ServeEngine


@dataclass(frozen=True)
class Sizes:
    max_seq: int
    chunk: int
    prefill_slots: int
    prompt_cap: int
    n_requests: int
    page_size: int
    swan: SwanConfig


def sizes(smoke: bool) -> Sizes:
    if smoke:       # the reference bench's --smoke family
        return Sizes(32, 4, 2, 8, 6, 16, SwanConfig(k_max=8, buffer=4))
    return Sizes(512, 32, 2, 256, 8, 64, SwanConfig(k_max=64, buffer=128))


def _workload(cfg, prompt_cap, n_requests, k_max, seed=0):
    """Randomized mixed workload; every prompt materialised up front."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n_requests):
        plen = int(rng.randint(1, prompt_cap + 1))
        toks = make_batch(cfg, 1, plen, seed=300 + i,
                          device="cpu")["tokens"][0].tolist()
        temp = float(rng.choice([0.0, 0.0, 0.7, 1.3]))
        reqs.append(Request(
            uid=f"req{i}", tokens=toks, max_new_tokens=int(rng.randint(2, 5)),
            temperature=temp, seed=int(rng.randint(0, 2**31 - 1)),
            k=[None, k_max // 2, k_max][int(rng.randint(0, 3))]))
    return reqs


def _clone(reqs):
    return [Request(uid=r.uid, tokens=list(r.tokens),
                    max_new_tokens=r.max_new_tokens,
                    temperature=r.temperature, seed=r.seed, k=r.k)
            for r in reqs]


def _ttft_ms(engine, req):
    """Wall-clock from submit to the first generated token (read off the
    engine's token counter), then drain.  The clock starts on an idle
    card: a warmup's dead-lane replays run asynchronously."""
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    engine.submit(req)
    t0 = time.perf_counter()
    while engine.metrics.value("serve_tokens_generated_total") < 1:
        engine.step()
    dt = (time.perf_counter() - t0) * 1e3
    while not engine.done:
        engine.step()
    return dt


def run(smoke: bool = False, device: DeviceLike = None) -> None:
    dev = resolve_device(device)
    sz = sizes(smoke)
    n_slots = 2
    with bench_record("warmup_torch", dev) as rec:
        rec.extra["smoke"] = smoke
        cfg, _, pj, absorbed = serve_model(smoke, dev, calib_len=24)
        k_half = sz.swan.k_max // 2

        def engine(**kw):
            return ServeEngine(cfg, absorbed, swan=sz.swan, projections=pj,
                               max_seq=sz.max_seq, n_slots=n_slots,
                               prefill_chunk=sz.chunk,
                               prefill_slots=sz.prefill_slots, graphs=True,
                               device=dev, **kw)

        reqs = _workload(cfg, sz.prompt_cap, sz.n_requests, sz.swan.k_max)
        ttft_tokens = list(reqs[0].tokens)

        def ttft_req():
            return Request(uid="ttft", tokens=list(ttft_tokens),
                           max_new_tokens=4, k=k_half)

        # --- cold first-request TTFT (pays its buckets' captures) --------
        cold = engine()
        cold_ms = _ttft_ms(cold, ttft_req())
        emit("warmup_ttft_cold", cold_ms * 1e3,
             f"prompt_len={len(ttft_tokens)}")
        del cold

        # --- warmed slab engine ------------------------------------------
        warm = engine()
        rep = warm.warmup(max_prompt_len=sz.prompt_cap)
        emit("warmup_slab", rep["warmup_ms"] * 1e3,
             f"captures={rep['captures']};census={rep['census']['total']};"
             f"items={len(rep['items'])}")
        rep2 = warm.warmup(max_prompt_len=sz.prompt_cap)
        gate("warmup_idempotent_slab", rep2["captures"] == 0,
             f"second warmup captured {rep2['captures']}")

        warm_ms = _ttft_ms(warm, ttft_req())
        ratio = warm_ms / cold_ms
        emit("warmup_ttft_warm", warm_ms * 1e3, f"ratio_vs_cold={ratio:.4f}")
        gate("warm_ttft_le_half_cold", ratio <= 0.5,
             f"warm {warm_ms:.1f}ms vs cold {cold_ms:.1f}ms "
             f"(ratio {ratio:.3f})")

        # --- post-warmup randomized workload: zero new captures ----------
        census0 = warm.executable_census()
        c0 = compile_events.total()
        t0 = time.perf_counter()
        comps_sync = warm.run(_clone(reqs))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        dc = compile_events.total() - c0
        census1 = warm.executable_census()
        n_tok = sum(len(c.tokens) for c in comps_sync)
        emit("warmup_steady_state_slab", dt / max(n_tok, 1) * 1e6,
             f"reqs={len(comps_sync)};tokens={n_tok};new_captures={dc}")
        gate("zero_steady_state_compiles_slab",
             dc == 0 and census1 == census0,
             f"new_captures={dc} census_delta="
             f"{census1['total'] - census0['total']}")
        record_metrics(warm.metrics, "slab")
        del warm

        # --- paged engine: warmup + zero-capture workload -----------------
        pg = engine(paged=True, page_size=sz.page_size)
        prep = pg.warmup(max_prompt_len=sz.prompt_cap)
        emit("warmup_paged", prep["warmup_ms"] * 1e3,
             f"captures={prep['captures']};census={prep['census']['total']}")
        gate("warmup_idempotent_paged",
             pg.warmup(max_prompt_len=sz.prompt_cap)["captures"] == 0,
             "second paged warmup captured")
        pcensus0 = pg.executable_census()
        c0 = compile_events.total()
        comps_paged = pg.run(_clone(reqs))
        dc = compile_events.total() - c0
        gate("zero_steady_state_compiles_paged",
             dc == 0 and pg.executable_census() == pcensus0,
             f"new_captures={dc}")
        if len(comps_paged) != len(reqs):
            raise RuntimeError(f"paged: {len(comps_paged)} of {len(reqs)} "
                               "requests completed")
        del pg

        # --- async fetch: token/step/dispatch identity to the sync path --
        e_sync = engine()
        e_async = engine(async_fetch=True)
        c1 = e_sync.run(_clone(reqs))
        c2 = e_async.run(_clone(reqs))
        t1 = {c.uid: c.tokens for c in c1}
        t2 = {c.uid: c.tokens for c in c2}
        s1 = {c.uid: (c.admitted_step, c.first_token_step, c.finished_step)
              for c in c1}
        s2 = {c.uid: (c.admitted_step, c.first_token_step, c.finished_step)
              for c in c2}
        gate("async_token_identity", t1 == t2 and s1 == s2,
             "async fetch must be token- and step-identical to sync")
        gate("async_dispatch_counts", e_sync.dispatches == e_async.dispatches,
             f"sync={e_sync.dispatches} async={e_async.dispatches}")
        # the warmed sync run above served the same workload
        gate("async_matches_warmed",
             t2 == {c.uid: c.tokens for c in comps_sync},
             "async tokens must match the warmed sync run")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's smoke family on its tiny model")
    ap.add_argument("--device", default=None,
                    help="cuda (default); the CPU has no graphs and raises")
    args = ap.parse_args()
    run(smoke=args.smoke, device=args.device)
