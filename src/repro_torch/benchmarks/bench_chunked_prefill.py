"""Chunked prefill under Poisson long-prompt arrivals: per-step latency
(port of ``benchmarks/bench_chunked_prefill.py``).

A monolithic admission prefills the whole prompt inside one engine step,
so every active decode slot stalls for it: the p99 engine-step latency
under a trace with occasional LONG prompts is set by those admission
steps.  Chunked prefill (``prefill_chunk``) spends a bounded token budget
per step and still runs the batched decode, so the worst step is "one
chunk + one decode" instead of "one long prefill + one decode".

Replays the SAME deterministic Poisson trace (short prompts and every
third one long) through a monolithic and a chunked slab engine at full
SWAN retention (winnowing exact: the engines must be token-identical),
timing every ``engine.step()`` (the card synchronised after each) after a
warmup pass over the same trace, best p99 of two timed passes.  Gates:

  * chunked tokens == monolithic tokens (full-k exactness);
  * p99 step latency improves under chunking by the reference's margin;
  * the worst chunked step stays under the worst monolithic step;
  * the prefill family stays O(log max_seq): on the card the CUDA graphs
    captured for monolithic and chunked prefill (the engine's census);
    an eager engine captures none.

    python -m repro_torch.benchmarks.bench_chunked_prefill [--smoke] [--device cpu]

``--smoke`` replays the reference's own trace on its tiny float32 model;
the default runs llama3-8b at full width on the card, graphed, in float32
as the reference's model is (full-f32 matrix products: token identity is
exact arithmetic's, and bf16 rounds the monolithic and chunked reads
differently), with the trace's prompt lengths, chunk and ring scaled by 8
as ``bench_serve_engine`` scales its trace (max_seq 4096, k = d_head).
``BENCH_chunked_prefill_torch.json`` lands in ``$REPRO_BENCH_OUT``.
"""
from __future__ import annotations

import argparse
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.benchmarks.common import (bench_record, emit, gate,
                                           serve_model)
from repro_torch.configs import SwanConfig
from repro_torch.device import DeviceLike, f32_matmul, resolve_device
from repro_torch.launch.io import make_batch
from repro_torch.runtime.serve_engine import Request, ServeEngine

N_SLOTS = 2
ARRIVAL_RATE = 0.5   # requests per engine step (Poisson)
N_PASSES = 2         # timed passes per engine; best-of damps host noise
P99_MARGIN = 1.15    # the reference's required improvement headroom


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
    n, gen, long_len = (6, 10, 320) if smoke else (9, 20, 384)
    return Sizes(512 if scale == 1 else 4096, 16 * scale, 8 * scale,
                 (8 * scale, 14 * scale), n, gen, long_len * scale)


def trace(cfg, sz: Sizes, tag="", step0=0):
    """Deterministic Poisson arrivals; every third prompt is LONG.
    ``step0`` offsets arrivals to the engine's current step count (an
    ``arrival_step`` is absolute)."""
    rng = np.random.default_rng(0)
    arrivals = np.floor(np.cumsum(
        rng.exponential(1.0 / ARRIVAL_RATE, sz.n_requests))).astype(int)
    reqs = []
    for i in range(sz.n_requests):
        plen = sz.long_len if i % 3 == 2 else sz.short[i % 2]
        toks = make_batch(cfg, 1, plen, seed=300 + i, device="cpu")["tokens"][0]
        reqs.append(Request(
            uid=f"{tag}req{i}", tokens=toks.tolist(),
            max_new_tokens=sz.gen_tokens,
            arrival_step=step0 + int(arrivals[i])))
    return reqs


def _timed_steps(engine, reqs):
    """Drain ``reqs`` step by step, timing each engine step (host clock,
    the card synchronised after each step)."""
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


def run(smoke: bool = False, device: DeviceLike = None, model=None):
    """Run the bench; ``model`` (cfg, params, projections, absorbed) stands
    in for ``serve_model``'s seeded one.  Returns the per-mode stats and
    the first timed pass's tokens by request."""
    dev = resolve_device(device)
    sz = sizes(smoke, 1 if smoke else 8)
    stats, tokens = {}, {}
    with bench_record("chunked_prefill_torch", dev) as rec, f32_matmul():
        rec.extra["smoke"] = smoke
        cfg, _, pj, absorbed = model or serve_model(smoke, dev,
                                                    dtype="float32")
        swan = SwanConfig(k_max=cfg.d_head, buffer=sz.buffer, mode="topk")
        for mode, chunk in [("monolithic", None), ("chunked", sz.chunk)]:
            eng = ServeEngine(cfg, absorbed, swan=swan, projections=pj,
                              max_seq=sz.max_seq, n_slots=N_SLOTS,
                              prefill_chunk=chunk, metrics=False, device=dev)
            # warmup: the same trace, so every bucket the timed passes hit
            # is captured (on the card) before the clock runs
            eng.run(trace(cfg, sz, tag="warm"))
            passes = []
            for n in range(N_PASSES):
                durs = _timed_steps(eng, trace(cfg, sz, tag=f"p{n}-",
                                               step0=eng.step_count))
                passes.append({"p50": float(np.percentile(durs, 50)),
                               "p99": float(np.percentile(durs, 99)),
                               "max": float(durs.max()),
                               "steps": len(durs)})
            tokens[mode] = {c.uid.split("-", 1)[-1]: c.tokens
                            for c in eng.completions
                            if c.uid.startswith("p0-")}
            stats[mode] = min(passes, key=lambda s: s["p99"])
            stats[mode]["prefill_execs"] = eng.prefill_cache_size
            del eng

        diff = [u for u in tokens["monolithic"]
                if tokens["chunked"].get(u) != tokens["monolithic"][u]]
        gate("token_identity", not diff and tokens["chunked"].keys()
             == tokens["monolithic"].keys(),
             f"chunked prefill diverged from monolithic admission on {diff}")
        mono, chk = stats["monolithic"], stats["chunked"]
        gate("p99_improves", chk["p99"] * P99_MARGIN < mono["p99"],
             f"chunked p99 {chk['p99'] * 1e3:.2f} ms did not improve on "
             f"monolithic {mono['p99'] * 1e3:.2f} ms by >= {P99_MARGIN}x")
        gate("worst_step_improves", chk["max"] < mono["max"],
             f"worst chunked step {chk['max'] * 1e3:.2f} ms not under the "
             f"worst monolithic step {mono['max'] * 1e3:.2f} ms")
        bound = 2 * int(math.log2(sz.max_seq)) + 2 if dev.type == "cuda" else 0
        gate("prefill_execs_log_bound",
             0 < chk["prefill_execs"] <= bound if bound
             else chk["prefill_execs"] == 0,
             f"{chk['prefill_execs']} prefill graphs; the bound is {bound} "
             f"on {dev.type}")

        for mode, s in stats.items():
            emit(f"chunked_prefill_{mode}", s["p99"] * 1e6,
                 f"p50_us={s['p50'] * 1e6:.0f};p99_us={s['p99'] * 1e6:.0f};"
                 f"max_us={s['max'] * 1e6:.0f};steps={s['steps']};"
                 f"prefill_execs={s['prefill_execs']}")
        emit("chunked_prefill_p99_speedup", mono["p99"] / chk["p99"],
             f"chunk={sz.chunk};long_len={sz.long_len};slots={N_SLOTS};"
             f"max_seq={sz.max_seq}")
    return stats, tokens


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's CI trace on its tiny float32 model")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(smoke=args.smoke, device=args.device)


if __name__ == "__main__":
    main()
