"""Batched concurrent prefill under a Poisson admission burst: p99 TTFT
(port of ``benchmarks/bench_concurrent_prefill.py``).

With one in-flight prefill advancing one chunk per engine step, an
admission burst serializes: the Nth queued request's time to first token
grows as O(queue depth × prompt chunks).  The batched concurrent
scheduler (``prefill_slots=P``) round-robins the per-step token budget
across up to P in-flight prefills and packs their chunks into ONE
multi-slot dispatch, so TTFT becomes O(prompt chunks) while each step
still issues one chunk dispatch and one decode dispatch.

Replays the SAME deterministic Poisson burst (clustered arrivals, mixed
short and long prompts) through a serial-prefill engine (P = 1) and a
batched-concurrent one (P = n_slots) at full SWAN retention.  TTFT is
counted in ENGINE STEPS, read off each engine's ``serve_ttft_steps``
histogram (its observations, arrival to first token, are checked against
the completions' step stamps): a scheduler property, so the gates hold on
any host:

  * batched tokens == serial tokens (the scheduler never changes outputs);
  * p99 TTFT (steps) of the batched engine <= 0.6 × the serial engine's;
  * the batched engine drains the trace in no more engine steps;
  * the multi-slot prefill family stays O(log slots × log chunk × log
    max_seq): on the card the captured prefill graphs; an eager engine
    captures none.

Wall-clock per-step latency is reported, not gated.

    python -m repro_torch.benchmarks.bench_concurrent_prefill [--smoke] [--device cpu]

``--smoke`` replays the reference's own trace on its tiny float32 model;
the default runs llama3-8b at full width on the card, graphed, in float32
as the reference's model is (full-f32 matrix products: in bf16 the serial
and batched chunks' different shapes round differently), with the trace's
prompt lengths, chunk and ring scaled by 8 (max_seq 4096, k = d_head).
``BENCH_concurrent_prefill_torch.json`` lands in ``$REPRO_BENCH_OUT`` with
both engines' metrics.
"""
from __future__ import annotations

import argparse
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.benchmarks.common import (bench_record, emit, gate,
                                           record_metrics, serve_model)
from repro_torch.configs import SwanConfig
from repro_torch.device import DeviceLike, f32_matmul, resolve_device
from repro_torch.launch.io import make_batch
from repro_torch.runtime.serve_engine import Request, ServeEngine

N_SLOTS = 8          # the burst fits in slots: TTFT is pure prefill scheduling
BURST_RATE = 3.0     # requests per engine step (Poisson): an admission burst
TTFT_GATE = 0.6      # required p99 TTFT ratio: batched <= 0.6 x serial


@dataclass(frozen=True)
class Sizes:
    max_seq: int
    chunk: int
    buffer: int
    short: tuple
    n_requests: int
    gen_tokens: int
    long_len: int


def sizes(smoke: bool, scale: int = 1) -> Sizes:
    """The reference's trace (``smoke``: its CI trace), lengths, chunk and
    ring times ``scale``; max_seq 512 on the reference's model, 4096 at
    full width."""
    n, gen, long_len = (8, 6, 96) if smoke else (8, 16, 192)
    return Sizes(512 if scale == 1 else 4096, 16 * scale, 8 * scale,
                 (12 * scale, 28 * scale), n, gen, long_len * scale)


def trace(cfg, sz: Sizes):
    """Deterministic Poisson burst: clustered arrivals, every third prompt
    LONG."""
    rng = np.random.default_rng(0)
    arrivals = np.floor(np.cumsum(
        rng.exponential(1.0 / BURST_RATE, sz.n_requests))).astype(int)
    reqs = []
    for i in range(sz.n_requests):
        plen = sz.long_len if i % 3 == 2 else sz.short[i % 2]
        toks = make_batch(cfg, 1, plen, seed=500 + i, device="cpu")["tokens"][0]
        reqs.append(Request(
            uid=f"req{i}", tokens=toks.tolist(),
            max_new_tokens=sz.gen_tokens, arrival_step=int(arrivals[i])))
    return reqs


def _drain_timed(engine, reqs):
    for r in reqs:
        engine.submit(r)
    durs = []
    while not engine.done:
        t0 = time.perf_counter()
        engine.step()
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        durs.append(time.perf_counter() - t0)
    return np.asarray(durs)


def _ttft_steps(engine, reqs) -> np.ndarray:
    """Each request's TTFT in engine steps, as ``serve_ttft_steps``
    observed it: the histogram must hold exactly these observations."""
    by = {c.uid: c for c in engine.completions}
    ttft = np.asarray([by[r.uid].first_token_step - r.arrival_step
                       for r in reqs], np.float64)
    hist = engine.metrics.get("serve_ttft_steps")
    gate("ttft_metric_matches",
         hist is not None and hist.count == len(reqs)
         and hist.sum == float(ttft.sum()),
         f"serve_ttft_steps holds {getattr(hist, 'count', 0)} observations "
         f"summing to {getattr(hist, 'sum', 0)}; the completions give "
         f"{len(reqs)} summing to {ttft.sum()}")
    return ttft


def run(smoke: bool = False, device: DeviceLike = None, model=None):
    """Run the bench; ``model`` (cfg, params, projections, absorbed) stands
    in for ``serve_model``'s seeded one.  Returns the per-mode stats,
    tokens by request and TTFT steps by request."""
    dev = resolve_device(device)
    sz = sizes(smoke, 1 if smoke else 8)
    stats, tokens, ttfts = {}, {}, {}
    with bench_record("concurrent_prefill_torch", dev) as rec, f32_matmul():
        rec.extra["smoke"] = smoke
        cfg, _, pj, absorbed = model or serve_model(smoke, dev,
                                                    dtype="float32")
        swan = SwanConfig(k_max=cfg.d_head, buffer=sz.buffer, mode="topk")
        for mode, p_slots in [("serial", 1), ("batched", N_SLOTS)]:
            eng = ServeEngine(cfg, absorbed, swan=swan, projections=pj,
                              max_seq=sz.max_seq, n_slots=N_SLOTS,
                              prefill_chunk=sz.chunk, prefill_slots=p_slots,
                              device=dev)
            reqs = trace(cfg, sz)
            durs = _drain_timed(eng, reqs)
            ttft = _ttft_steps(eng, reqs)
            tokens[mode] = {c.uid: c.tokens for c in eng.completions}
            ttfts[mode] = {r.uid: int(t) for r, t in zip(reqs, ttft)}
            stats[mode] = {
                "ttft_p50": float(np.percentile(ttft, 50)),
                "ttft_p99": float(np.percentile(ttft, 99)),
                "ttft_max": float(ttft.max()),
                "engine_steps": eng.step_count,
                "step_p99_us": float(np.percentile(durs, 99) * 1e6),
                "prefill_execs": eng.prefill_cache_size,
            }
            record_metrics(eng.metrics, mode)
            del eng

        ser, bat = stats["serial"], stats["batched"]
        diff = [u for u in tokens["serial"]
                if tokens["batched"].get(u) != tokens["serial"][u]]
        gate("token_identity", not diff and tokens["batched"].keys()
             == tokens["serial"].keys(),
             f"batched concurrent prefill diverged from the serial scheduler "
             f"on {diff}")
        gate("ttft_p99", bat["ttft_p99"] <= TTFT_GATE * ser["ttft_p99"],
             f"batched p99 TTFT {bat['ttft_p99']:.0f} steps did not reach "
             f"{TTFT_GATE}x serial ({ser['ttft_p99']:.0f} steps)")
        gate("no_extra_steps", bat["engine_steps"] <= ser["engine_steps"],
             "batched scheduler slowed decode drain (more engine steps)")
        bound = ((int(math.log2(N_SLOTS)) + 1) * 2
                 * (int(math.log2(sz.max_seq)) + 1)
                 if dev.type == "cuda" else 0)
        gate("prefill_execs_bound",
             0 < bat["prefill_execs"] <= bound if bound
             else bat["prefill_execs"] == 0,
             f"{bat['prefill_execs']} multi-slot prefill graphs; the bound "
             f"is {bound} on {dev.type}")

        for mode, s in stats.items():
            emit(f"concurrent_prefill_{mode}", s["ttft_p99"],
                 f"ttft_p50={s['ttft_p50']:.0f};ttft_p99={s['ttft_p99']:.0f};"
                 f"ttft_max={s['ttft_max']:.0f};steps={s['engine_steps']};"
                 f"step_p99_us={s['step_p99_us']:.0f};"
                 f"prefill_execs={s['prefill_execs']}")
        emit("concurrent_prefill_ttft_speedup",
             ser["ttft_p99"] / max(bat["ttft_p99"], 1e-9),
             f"slots={N_SLOTS};chunk={sz.chunk};burst_rate={BURST_RATE};"
             f"gate={TTFT_GATE}")
    return stats, tokens, ttfts


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's CI trace on its tiny float32 model")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(smoke=args.smoke, device=args.device)


if __name__ == "__main__":
    main()
