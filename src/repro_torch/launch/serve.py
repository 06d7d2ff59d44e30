"""Serving launcher of the port: init seeded weights, calibrate and absorb
SWAN, run batched generation — the lockstep ``ServeSession``, or with
``--engine`` the continuous-batching ``ServeEngine`` (queue, slots,
per-request k, slab or ``--paged`` cache, ``--prefill-chunk`` chunked
concurrent prefill).

    python -m repro_torch.launch.serve --arch llama3-8b --swan \
        --k 64 --buffer 128 --prompt-len 2048 --tokens 64 --max-seq 4096
    python -m repro_torch.launch.serve --arch llama3-8b --swan --k 64 \
        --buffer 128 --prompt-len 2048 --tokens 32 --max-seq 4096 \
        --engine --requests 8 --mixed-k --paged --prefill-chunk 256 \
        --prefill-slots 2
    python -m repro_torch.launch.serve --arch llama3-8b --smoke \
        --ckpt-dir ckpt --swan --k 8 --buffer 8 --device cpu
    python -m repro_torch.launch.serve --arch olmo-1b --smoke --swan \
        --k 8 --buffer 8 --device cpu

``--arch`` is any arch of the port's registry: llama3-8b, yi-9b (GQA, 8
queries per kv head), olmo-1b (MHA, non-parametric LayerNorm, tied
embeddings), deepseek-moe-16b or qwen2-moe-a2.7b (mixture-of-experts
FFNs; qwen2 with q/k/v biases), internvl2-1b (7 queries per kv head; the
lockstep prompt carries 256 patch embeddings ahead of its tokens, the
engine's requests tokens only) or whisper-small (an encoder over 1500
frames, cross-attention; lockstep only: ``--engine`` is refused, as by
the reference), jamba-1.5-large-398b (Mamba layers, one attention layer
in 8, which ``--swan`` winnows, MoE FFNs) or rwkv6-3b (RWKV-6, no
attention: ``--swan`` exits non-zero, "SWAN inapplicable", as the
reference's launcher does), each at its full published configuration or,
with ``--smoke``, its small one.  The two recurrent families serve the
engine monolithically on the slab at the config's k (no ``--paged``,
``--prefill-chunk`` or ``--mixed-k``, as in the reference).  internvl2-1b's lockstep tokens differ from
the reference launcher's on the same weights by design: the reference's
session decodes its first token at the token count, inside the patch
prefix, and the port's at the prefill's full length.  ``--pool-pages`` (the reference's
flag) sizes the paged pool below the full reservation.
``--data-parallel N`` (or ``--mesh-shape data=N,...``) serves the engine
over a ``('data',)`` mesh of N shards (``repro_torch.launch.mesh``): on
``--device cpu`` its devices are N CPU entries, on the card N visible
cards, so one card refuses N > 1, as the reference refuses a mesh larger
than its devices.

run on the card, where every dispatch replays a CUDA graph per shape
bucket (``--engine --warmup`` captures the engine's whole graph family
before the first request, and ``--async-fetch`` overlaps the decode
token copy with the next step's scheduling); ``--smoke --device cpu``
runs the small configuration eagerly through the plain PyTorch path on
the CPU.  ``--metrics-out`` writes the final metrics (Prometheus text for
``.prom``/``.txt``, JSON otherwise), ``--trace-out`` streams the engine's
JSONL event trace, and ``--profile-steps N`` writes a ``torch.profiler``
trace of the first N engine steps into ``--profile-dir``
(``repro_torch.obs``).  ``--ckpt-dir`` serves the params of the latest
checkpoint there (one written by ``repro_torch.launch.train`` or by the
reference's trainer) instead of seeded random weights.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import SwanConfig, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels import KERNELS
from repro_torch.kernels.build import build_all
from repro_torch.launch.io import make_batch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.registry import get_model, swan_applicable
from repro_torch.obs import EventTrace
from repro_torch.runtime.serve_engine import Request, ServeEngine
from repro_torch.runtime.serve_loop import ServeSession, calibrate_swan


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Parse ``argv`` and serve; returns the ``ServeEngine`` (``--engine``)
    or ``ServeSession`` that served."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", help="restore params from a checkpoint")
    ap.add_argument("--swan", action="store_true")
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--buffer", type=int, default=128)
    ap.add_argument("--mode", default="topk", choices=["topk", "truncate"])
    ap.add_argument("--quantize", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--engine", action="store_true",
                    help="continuous batching instead of lockstep")
    ap.add_argument("--requests", type=int, default=None,
                    help="engine: number of requests (default: --batch * 2)")
    ap.add_argument("--mixed-k", action="store_true",
                    help="engine: cycle per-request SWAN k overrides")
    ap.add_argument("--paged", action="store_true",
                    help="engine+swan: paged sparse cache (memory follows "
                         "live tokens)")
    ap.add_argument("--page-size", type=int, default=64,
                    help="paged: token positions per page")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="paged: physical pages in the shared pool "
                         "(default: full reservation; smaller over-commits)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="engine: chunked prefill in power-of-two chunks "
                         "(default: monolithic admission)")
    ap.add_argument("--prefill-slots", type=int, default=1,
                    help="engine: in-flight prefills advanced per step in "
                         "one chunk dispatch (requires --prefill-chunk)")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="engine: per-step prefill token budget "
                         "(default: prefill-slots * prefill-chunk)")
    ap.add_argument("--data-parallel", type=int, default=None,
                    help="engine: shard slots, caches and the paged pool "
                         "over a ('data',) mesh of this many devices "
                         "(shard-local slot scheduler; n_slots must "
                         "divide)")
    ap.add_argument("--mesh-shape", default=None,
                    help="engine: explicit mesh as 'AXIS=N,AXIS=N' (must "
                         "include a data axis), e.g. 'data=4' or "
                         "'data=4,model=2' — overrides --data-parallel")
    ap.add_argument("--pool-grow", action="store_true",
                    help="paged: grow the pool when it runs dry instead of "
                         "holding admissions")
    ap.add_argument("--admission", default="fifo", choices=["fifo", "srf"],
                    help="engine: admission policy (fifo, or "
                         "shortest-remaining-first)")
    ap.add_argument("--warmup", action="store_true",
                    help="engine: capture the whole CUDA-graph family "
                         "before the first request (runtime.warmup) — no "
                         "capture mid-serve; prints the warmup report "
                         "summary")
    ap.add_argument("--max-prompt-len", type=int, default=None,
                    help="engine: trim the warmed prefix family to prompts "
                         "of at most this many tokens (default max-seq); "
                         "longer prompts still serve — their buckets are "
                         "captured at first use")
    ap.add_argument("--async-fetch", action="store_true",
                    help="engine: overlap host scheduling with the decode "
                         "token copy (pinned, non-blocking, resolved at the "
                         "next step; token-identical)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the final metrics snapshot here: "
                         "Prometheus text if the path ends in .prom/.txt, "
                         "JSON otherwise (repro_torch.obs.metrics)")
    ap.add_argument("--trace-out", default=None,
                    help="engine: stream a structured JSONL event trace "
                         "(admissions, dispatches, first tokens, page "
                         "map/free, ...) to this path (repro_torch.obs.trace)")
    ap.add_argument("--profile-steps", type=int, default=None,
                    help="engine: write one torch.profiler trace spanning "
                         "this many engine steps into --profile-dir")
    ap.add_argument("--profile-dir", default="profile",
                    help="engine: torch.profiler trace output directory")
    args = ap.parse_args(argv)
    if (args.warmup or args.async_fetch) and not args.engine:
        raise SystemExit("--warmup/--async-fetch require --engine")
    if args.prefill_chunk and not args.engine:
        raise SystemExit("--prefill-chunk requires --engine")
    if ((args.prefill_slots > 1 or args.prefill_budget is not None)
            and not args.prefill_chunk):
        raise SystemExit("--prefill-slots/--prefill-budget require "
                         "--prefill-chunk")
    if args.paged and not (args.engine and args.swan):
        raise SystemExit("--paged requires --engine and --swan")
    if (args.data_parallel or args.mesh_shape) and not args.engine:
        raise SystemExit("--data-parallel/--mesh-shape require --engine")
    if args.pool_grow and not args.paged:
        raise SystemExit("--pool-grow requires --paged")
    if (args.trace_out or args.profile_steps) and not args.engine:
        raise SystemExit("--trace-out/--profile-steps require --engine")

    device = resolve_device(args.device)
    graphs = device.type == "cuda"
    if args.warmup and not graphs:
        raise SystemExit("--warmup captures CUDA graphs: it needs a CUDA "
                         "device")
    if device.type == "cuda":   # build before anything is timed
        t0 = time.perf_counter()
        build_all(KERNELS)
        print(f"kernels built in {time.perf_counter() - t0:.1f}s")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    api = get_model(cfg)
    params = api.init_params(cfg, 0, device)
    if args.ckpt_dir:
        ck = Checkpointer(args.ckpt_dir)
        step = ck.latest_step()
        if step is not None:
            params = ck.restore(step, {"params": params})["params"]
            print(f"restored checkpoint step {step}")

    swan = projections = None
    if args.swan:
        if not swan_applicable(cfg):
            raise SystemExit(f"SWAN inapplicable to {cfg.name}")
        b = min(args.buffer, args.max_seq // 4)
        swan = SwanConfig(k_max=args.k or cfg.d_head // 2, buffer=b,
                          mode=args.mode, quantize=args.quantize)
        projections = calibrate_swan(api, cfg, params,
                                     make_batch(cfg, 4, 64, seed=3,
                                                device=device))
        params = api.absorb(params, cfg, projections)
        print(f"SWAN: k_max={swan.k_max}/{cfg.d_head} buffer={b} "
              f"mode={swan.mode} int8={swan.quantize}")

    if args.engine:
        return _run_engine(cfg, params, swan, projections, args, device,
                           graphs)

    sess = ServeSession(cfg, params, swan=swan, projections=projections,
                        max_seq=args.max_seq, batch=args.batch,
                        graphs=graphs, device=device,
                        metrics=bool(args.metrics_out))
    prompt = make_batch(cfg, args.batch, args.prompt_len, seed=11,
                        device=device)
    _sync(device)
    t0 = time.perf_counter()
    out = sess.generate(prompt, args.tokens, temperature=args.temperature)
    _sync(device)
    dt = time.perf_counter() - t0
    for i in range(min(args.batch, 2)):
        print(f"seq {i}: {out[i].tolist()}")
    n_tok = out.numel()
    print(f"generated {n_tok} tokens in {dt:.3f}s ({n_tok / dt:.1f} tok/s, "
          f"prefill and graph captures included) on {device}, "
          f"{'graphed' if graphs else 'eager'}")
    rep = sess.cache_report()
    extra = f" ({rep['saving']:.0%} vs dense)" if "saving" in rep else ""
    print(f"cache [{rep['mode']}]: {rep['bytes'] / 1e6:.2f} MB{extra}")
    _write_metrics(sess.metrics, args.metrics_out)
    return sess


def _write_metrics(registry, path) -> None:
    """Dump a registry snapshot: Prometheus text for .prom/.txt paths,
    JSON otherwise.  No-op when path is None."""
    if not path:
        return
    if path.endswith((".prom", ".txt")):
        body = registry.to_prometheus()
    else:
        body = registry.to_json(indent=2)
    with open(path, "w") as fh:
        fh.write(body)
    print(f"metrics -> {path}")


def _serve_mesh(args, device: torch.device):
    """The engine's mesh from --mesh-shape / --data-parallel (None = one
    shard): N entries of the CPU, or N visible cards."""
    if args.mesh_shape:
        pairs = [kv.split("=") for kv in args.mesh_shape.split(",")]
        shape, axes = [int(n) for _, n in pairs], [ax for ax, _ in pairs]
    elif args.data_parallel:
        shape, axes = [args.data_parallel], ["data"]
    else:
        return None
    n = 1
    for x in shape:
        n *= x
    try:
        return make_mesh(shape, axes,
                         [device] * n if device.type == "cpu" else None)
    except ValueError as e:
        raise SystemExit(f"--data-parallel/--mesh-shape: {e}") from e


def _run_engine(cfg, params, swan, projections, args, device,
                graphs: bool) -> ServeEngine:
    mesh = _serve_mesh(args, device)
    trace = EventTrace(args.trace_out, keep=False) if args.trace_out else None
    eng = ServeEngine(cfg, params, swan=swan, projections=projections,
                      max_seq=args.max_seq, n_slots=args.batch,
                      paged=args.paged, page_size=args.page_size,
                      n_pages=args.pool_pages,
                      prefill_chunk=args.prefill_chunk,
                      prefill_slots=args.prefill_slots,
                      prefill_budget=args.prefill_budget,
                      mesh=mesh, pool_grow=args.pool_grow,
                      admission=args.admission, graphs=graphs,
                      async_fetch=args.async_fetch, trace=trace,
                      device=device)
    if args.warmup:
        rep = eng.warmup(max_prompt_len=args.max_prompt_len)
        print(f"warmup: {rep['census']['total']} graphs, {rep['captures']} "
              f"captures in {rep['warmup_ms']:.0f} ms "
              f"({ {k: v['captures'] for k, v in rep['by_kind'].items()} })")
    if args.profile_steps:
        eng.profile_steps(args.profile_steps, args.profile_dir)
    if mesh is not None:
        print(f"mesh: {dict(mesh.shape)} — {eng.dp} shards x "
              f"{eng.n_local} slots")
    n_req = args.requests or args.batch * 2
    k_cycle = ([None] if (swan is None or not args.mixed_k)
               else [swan.k_max, max(swan.k_max // 2, 1),
                     max(swan.k_max // 4, 1)])
    reqs = []
    for i in range(n_req):
        plen = max(4, args.prompt_len - 3 * (i % 4))     # mixed prompt lengths
        toks = make_batch(cfg, 1, plen, seed=100 + i, device="cpu")["tokens"][0]
        reqs.append(Request(
            uid=f"req{i}", tokens=[int(t) for t in toks],
            max_new_tokens=args.tokens, temperature=args.temperature,
            seed=i, k=k_cycle[i % len(k_cycle)]))
    _sync(device)
    t0 = time.perf_counter()
    comps = eng.run(reqs)
    _sync(device)
    dt = time.perf_counter() - t0
    n_tok = sum(len(c.tokens) for c in comps)
    for c in comps[:2]:
        print(f"{c.uid} (prompt {c.prompt_len}, k={c.k}, "
              f"steps {c.admitted_step}->{c.finished_step}): {c.tokens}")
    rep = eng.cache_report()
    extra = f" ({rep['saving']:.0%} vs dense)" if "saving" in rep else ""
    print(f"engine: {len(comps)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s, {eng.step_count} steps, dispatches "
          f"{eng.dispatches}) on {device}, "
          f"{'graphed' if graphs else 'eager'}")
    if graphs:
        print(f"graphs: {eng.executable_census()['total']} held, "
              f"{sum(eng._graphs.lazy_captures.values())} captured mid-serve")
    print(f"cache [{rep['mode']}]: {rep['bytes'] / 1e6:.2f} MB{extra}")
    if args.paged:
        print(f"paged: reserved {rep['reserved_bytes'] / 1e6:.2f} MB over "
              f"{rep['n_pages']} pages ({rep['page_size']} tok/page); "
              f"live now {rep['live_pages']} pages / "
              f"{rep['live_bytes'] / 1e6:.2f} MB "
              f"(slab layout would hold {rep['slab_bytes'] / 1e6:.2f} MB)")
    ttft = eng.metrics.get("serve_ttft_steps")
    if ttft is not None and ttft.count:
        print(f"ttft: p50 ~{ttft.quantile(0.5):.0f} steps, "
              f"p99 ~{ttft.quantile(0.99):.0f} steps (bucket-resolution)")
    if eng._profiler is not None and eng._profiler.path:
        print(f"profile -> {eng._profiler.path}")
    _write_metrics(eng.metrics, args.metrics_out)
    if trace is not None:
        trace.close()
        print(f"trace -> {args.trace_out}")
    return eng


if __name__ == "__main__":
    main()
