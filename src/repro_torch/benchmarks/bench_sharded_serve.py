"""Mesh-sharded serve engine under the Poisson trace: token identity and
dispatch-count independence from the shard count (port of
``benchmarks/bench_sharded_serve.py``).

The sharded engine lays its batched state (slab and ring leaves, the
paged pool's page axis) out over a ``data`` mesh axis, with a shard-local
slot scheduler on the host (admission, budgeted round-robin prefill and
retirement decide per shard).  The property gated here is the one that
makes the design scale: the host issues at most ONE packed chunk dispatch
and ONE decode dispatch per engine step however many shards the mesh has,
and the sharded schedule changes no output token.

The SAME deterministic Poisson trace (mixed prompt lengths, mixed
per-request SWAN k, clustered arrivals, concurrent chunked prefill, paged
pool) runs through a one-shard engine and a ``dp``-shard engine (8 on the
CPU, 2 on the card, ``--dp`` to choose; the mesh laid over the one
device), gated as the reference gates:

  * sharded tokens == one-shard tokens, per request.  In bf16 (the card's
    default) a chunk dispatch's lane count differs between the two engines
    (``[dp, P_local]``) and a bf16 product's rounding may follow it, so
    where the transcripts part the gate is ``repro_torch.benchmarks.
    parity.compare`` instead (``token_near_tie``): a near-tie within 5e-2
    at the parting token and every shared token's whole logits row within
    ``ROW_TOL``, as ``chip_smoke.py``'s ``sharded`` phase holds them;
  * at most one chunk and one decode dispatch per step, on either engine;
  * the sharded engine drains the trace in no more engine steps and no
    more dispatches than the one-shard engine.

Step wall times are reported, not gated.  The reference's instrumentation
gate follows: identical one-shard drains with metrics and tracing off vs
on give the same tokens and dispatches, and the instrumented p99 step
stays within 3 % + 300 µs of the bare one.

    python -m repro_torch.benchmarks.bench_sharded_serve [--smoke] \
        [--device cpu] [--dp N]

``--smoke`` runs the reference's own trace on its tiny float32 model; the
default runs llama3-8b at full width in bf16 on the card with the trace's
prompt lengths, k and page size scaled (``SwanConfig(k_max=64,
buffer=128)``, 64-token pages, chunks of 256, max_seq 4096; engines start
unwarmed, so the times include each graph's capture).
``BENCH_sharded_serve_torch.json`` lands in ``$REPRO_BENCH_OUT`` (default
``bench_out/``), where ``repro_torch.benchmarks.run`` folds it into the
summary.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.benchmarks.common import (bench_record, emit, gate,
                                           record_metrics, serve_model)
from repro_torch.benchmarks.parity import (ROW_TOL, compare, describe,
                                           record_logits)
from repro_torch.configs import SwanConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.io import make_batch
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.obs import EventTrace
from repro_torch.runtime.serve_engine import Request, ServeEngine

BURST_RATE = 2.0     # requests per engine step (Poisson)


@dataclass(frozen=True)
class Sizes:
    n_slots: int
    max_seq: int
    chunk: int
    page: int
    prompts: Tuple[int, ...]
    ks: Tuple[Optional[int], ...]
    swan: SwanConfig


def sizes(smoke: bool) -> Sizes:
    if smoke:       # the reference bench's own (k_max = d_head = 16)
        return Sizes(16, 128, 8, 8, (8, 20, 44, 14), (16, 8, None, 4),
                     SwanConfig(k_max=16, buffer=8, mode="topk"))
    return Sizes(8, 4096, 256, 64, (256, 640, 1408, 448), (64, 32, None, 16),
                 SwanConfig(k_max=64, buffer=128, mode="topk"))


def _trace(cfg, sz: Sizes, n_requests, gen_tokens):
    """Deterministic Poisson trace: clustered arrivals, mixed prompt
    lengths, mixed per-request k."""
    rng = np.random.default_rng(0)
    arrivals = np.floor(np.cumsum(
        rng.exponential(1.0 / BURST_RATE, n_requests))).astype(int)
    reqs = []
    for i in range(n_requests):
        plen = sz.prompts[i % 4]
        toks = make_batch(cfg, 1, plen, seed=500 + i, device="cpu")["tokens"][0]
        reqs.append(Request(
            uid=f"req{i}", tokens=toks.tolist(), max_new_tokens=gen_tokens,
            k=sz.ks[i % 4], arrival_step=int(arrivals[i])))
    return reqs


def _drain(engine, reqs):
    """Step the trace to the end, the card synchronised after each step;
    (per-step (chunk, decode) dispatches, step seconds)."""
    for r in reqs:
        engine.submit(r)
    cuda = engine.device.type == "cuda"
    per_step, durs = [], []
    while not engine.done:
        before = dict(engine.dispatches)
        t0 = time.perf_counter()
        engine.step()
        if cuda:
            torch.cuda.synchronize(engine.device)
        durs.append(time.perf_counter() - t0)
        per_step.append(tuple(engine.dispatches[k] - before[k]
                              for k in ("chunk", "decode")))
    return per_step, np.asarray(durs)


def run(smoke: bool = False, device: DeviceLike = None,
        dp: Optional[int] = None) -> None:
    dev = resolve_device(device)
    dp = dp or (2 if dev.type == "cuda" else 8)
    sz = sizes(smoke)
    n_requests, gen_tokens = (10, 5) if smoke else (24, 12)
    with bench_record("sharded_serve_torch", dev) as rec:
        rec.extra.update(smoke=smoke, dp=dp)
        cfg, _, pj, absorbed = serve_model(smoke, dev)

        def make(mesh, **kw):
            return ServeEngine(cfg, absorbed, swan=sz.swan, projections=pj,
                               max_seq=sz.max_seq, n_slots=sz.n_slots,
                               paged=True, page_size=sz.page,
                               prefill_chunk=sz.chunk, prefill_slots=4,
                               mesh=mesh, device=dev, **kw)

        stats, tokens, rows = {}, {}, {}
        bf16 = cfg.dtype == "bfloat16"
        for mode, mesh in (("single", None),
                           ("sharded", make_serve_mesh(dp, [dev] * dp))):
            eng = make(mesh)
            if bf16:
                rows[mode] = {}
                record_logits(eng, rows[mode])
            per_step, durs = _drain(eng, _trace(cfg, sz, n_requests,
                                                gen_tokens))
            tokens[mode] = {c.uid: c.tokens for c in eng.completions}
            stats[mode] = {
                "dp": eng.dp, "engine_steps": eng.step_count,
                "chunk_dispatches": eng.dispatches["chunk"],
                "decode_dispatches": eng.dispatches["decode"],
                "max_per_step": max(sum(d) for d in per_step),
                "per_step": per_step,
                "step_p50_us": float(np.percentile(durs, 50) * 1e6),
                "step_p99_us": float(np.percentile(durs, 99) * 1e6)}
            gate(f"{mode}_pool_drained", eng.pool.live_pages == 0,
                 f"{eng.pool.live_pages} pages live after the drain")
            eng.pool.check_consistent()
            record_metrics(eng.metrics, mode)
            del eng

        # --- acceptance gates (the reference's) ------------------------
        one, sh = stats["single"], stats["sharded"]
        gate("shard_counts", sh["dp"] == dp and one["dp"] == 1,
             f"dp={one['dp']}/{sh['dp']}")
        same = tokens["sharded"] == tokens["single"]
        if same or not bf16:
            gate("token_identity", same,
                 "sharded engine diverged from the single-device engine")
        else:
            c = compare(tokens["single"], rows["single"], tokens["sharded"],
                        rows["sharded"], ROW_TOL)
            rec.extra["near_tie"] = c
            print(f"sharded vs single: {describe(c)}", flush=True)
            gate("token_near_tie", c["ok"],
                 f"sharded vs single beyond a bf16 near-tie: {describe(c)}")
        rows.clear()
        gate("one_dispatch_per_step",
             max(one["max_per_step"], sh["max_per_step"]) <= 2,
             "more than one chunk + one decode dispatch in a step")
        gate("no_per_shard_dispatch",
             all(c <= 1 and d <= 1 for c, d in sh["per_step"]),
             "a sharded step issued per-shard dispatches")
        gate("no_extra_steps", sh["engine_steps"] <= one["engine_steps"],
             "sharding slowed the drain (more engine steps)")
        gate("no_extra_dispatches",
             sh["chunk_dispatches"] + sh["decode_dispatches"]
             <= one["chunk_dispatches"] + one["decode_dispatches"],
             "sharding increased total dispatch count")
        for mode, s in stats.items():
            emit(f"sharded_serve_{mode}",
                 s["chunk_dispatches"] + s["decode_dispatches"],
                 f"dp={s['dp']};steps={s['engine_steps']};"
                 f"chunk={s['chunk_dispatches']};"
                 f"decode={s['decode_dispatches']};"
                 f"max_per_step={s['max_per_step']};"
                 f"step_p50_us={s['step_p50_us']:.0f};"
                 f"step_p99_us={s['step_p99_us']:.0f}")
        emit("sharded_serve_dispatch_ratio",
             (sh["chunk_dispatches"] + sh["decode_dispatches"])
             / max(one["chunk_dispatches"] + one["decode_dispatches"], 1),
             f"dp={dp};slots={sz.n_slots};chunk={sz.chunk};page={sz.page};"
             f"burst_rate={BURST_RATE}")

        # --- instrumentation overhead: identical one-shard drains, warm,
        # with metrics and tracing off vs on ---------------------------
        p99, toks_oo, disp_oo = {}, {}, {}
        for tag in ("off", "on"):
            on = tag == "on"
            eng = make(None, metrics=on, trace=EventTrace() if on else None)
            _drain(eng, _trace(cfg, sz, n_requests, gen_tokens))   # warm
            best = []
            for _ in range(2):
                _, durs = _drain(eng, _trace(cfg, sz, n_requests,
                                             gen_tokens))
                best.append(float(np.percentile(durs, 99)))
            p99[tag] = min(best)
            toks_oo[tag] = {c.uid: c.tokens for c in eng.completions}
            disp_oo[tag] = dict(eng.dispatches)
            del eng
        gate("obs_token_identity", toks_oo["on"] == toks_oo["off"],
             "metrics/tracing changed output tokens")
        gate("obs_dispatch_identity", disp_oo["on"] == disp_oo["off"],
             f"metrics/tracing changed dispatch counts: "
             f"{disp_oo['off']} vs {disp_oo['on']}")
        budget = p99["off"] * 1.03 + 300e-6
        gate("obs_overhead_p99", p99["on"] <= budget,
             f"instrumented p99 {p99['on'] * 1e6:.0f}us exceeds "
             f"{budget * 1e6:.0f}us (off: {p99['off'] * 1e6:.0f}us)")
        emit("sharded_serve_obs_overhead_p99", p99["on"] * 1e6,
             f"off_p99_us={p99['off'] * 1e6:.0f};"
             f"ratio={p99['on'] / max(p99['off'], 1e-12):.3f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's small trace and tiny model")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--dp", type=int, default=None,
                    help="shards of the sharded engine (default: 2 on the "
                         "card, 8 on the CPU)")
    args = ap.parse_args(argv)
    run(smoke=args.smoke, device=args.device, dp=args.dp)


if __name__ == "__main__":
    main()
