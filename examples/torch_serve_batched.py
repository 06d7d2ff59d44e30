"""End-to-end serving example of the PyTorch/CUDA port: a continuous-batching
engine over a model of the dense family with dense vs SWAN-compressed KV
caches.

    PYTHONPATH=src python examples/torch_serve_batched.py [--arch llama3-8b] \
        [--smoke] [--device cpu] [--no-swan] [--k 8] [--buffer 16] \
        [--quantize] [--slots 4] [--requests 8] [--paged] \
        [--prefill-chunk 16 [--prefill-slots 2]] [--warmup] [--async-fetch] \
        [--data-parallel 2]

The counterpart of ``examples/serve_batched.py``, on the card by default
(every dispatch a CUDA graph replay; ``--warmup`` captures the engine's
whole family first).  Requests with mixed prompt lengths go to
``repro_torch.runtime.serve_engine.ServeEngine``, which admits them into
cache slots as capacity frees up and decodes all active sequences in one
step with per-sequence positions; the SWAN run also cycles per-request
compression levels k through one decode graph.  Reported: wall-clock
throughput, scheduler steps and physical cache bytes (paper Eq. 1) for
dense vs SWAN on the same requests.  ``--smoke`` takes the reference
example's small float32 model (llama3-8b) or the arch's smoke
configuration in float32; without it the full published configuration
runs in bf16.  ``--data-parallel N`` shards every engine's slots, caches
and paged pool over a ``('data',)`` mesh of N shards laid over the one
device (``make_serve_mesh(N, devices=[device] * N)``; ``--slots`` must
divide).  The reference's ``--use-pallas`` is left out: the kernels follow
the tensors' device here.
"""
import argparse
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "src"))

from repro_torch.configs import (ARCH_IDS, SwanConfig,  # noqa: E402
                                 get_config, get_smoke_config)
from repro_torch.launch.io import make_batch  # noqa: E402
from repro_torch.launch.mesh import make_serve_mesh  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.runtime.serve_engine import Request, ServeEngine  # noqa: E402
from repro_torch.runtime.serve_loop import calibrate_swan  # noqa: E402


def model_config(arch, smoke):
    """The reference example's model for llama3-8b at ``smoke`` (4 layers,
    d_model 128, 8/4 heads of 16, float32), the arch's float32 smoke
    configuration otherwise, or the full published configuration."""
    if not smoke:
        return get_config(arch)
    cfg = get_smoke_config(arch).replace(dtype="float32",
                                         param_dtype="float32")
    if arch == "llama3-8b":
        cfg = cfg.replace(n_layers=4, d_model=128, n_heads=8, n_kv_heads=4,
                          d_head=16, d_ff=256)
    return cfg


def main(argv=None, params=None):
    """Serve the requests; ``params`` (the model's raw weights on the
    device) stand in for the seeded ones."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the reference example's small float32 model")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--no-swan", action="store_true")
    ap.add_argument("--paged", action="store_true",
                    help="also run the paged sparse cache (memory follows "
                         "live tokens)")
    ap.add_argument("--page-size", type=int, default=32)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill: power-of-two tokens per chunk")
    ap.add_argument("--prefill-slots", type=int, default=1,
                    help="batched concurrent prefill: up to P in-flight "
                         "prefills per step in one multi-slot dispatch "
                         "(requires --prefill-chunk)")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="per-step prefill token budget (default: "
                         "prefill-slots * prefill-chunk)")
    ap.add_argument("--data-parallel", type=int, default=None,
                    help="shard slots, caches and the paged pool over a "
                         "('data',) mesh of this many shards on the one "
                         "device (--slots must divide)")
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--buffer", type=int, default=16)
    ap.add_argument("--quantize", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=48)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--stats-every", type=int, default=0,
                    help="print a stats line every N engine steps, read "
                         "off engine.metrics")
    ap.add_argument("--warmup", action="store_true",
                    help="capture each engine's whole graph family before "
                         "its first request (needs the card)")
    ap.add_argument("--async-fetch", action="store_true",
                    help="overlap host scheduling with the decode token "
                         "copy (token-identical to the sync path)")
    args = ap.parse_args(argv)
    if ((args.prefill_slots > 1 or args.prefill_budget is not None)
            and not args.prefill_chunk):
        raise SystemExit("--prefill-slots/--prefill-budget require "
                         "--prefill-chunk")

    cfg = model_config(args.arch, args.smoke)
    api = get_model(cfg)
    dev = args.device
    if params is None:
        params = api.init_params(cfg, 0, dev)
    mesh = (make_serve_mesh(args.data_parallel, [dev] * args.data_parallel)
            if args.data_parallel else None)
    engine_kw = dict(max_seq=args.max_seq, n_slots=args.slots, mesh=mesh,
                     prefill_chunk=args.prefill_chunk,
                     prefill_slots=args.prefill_slots,
                     prefill_budget=args.prefill_budget,
                     async_fetch=args.async_fetch, device=dev)

    def requests(k_cycle):
        out = []
        for i in range(args.requests):
            plen = max(4, args.prompt_len - 5 * (i % 4))   # mixed lengths
            toks = make_batch(cfg, 1, plen, seed=100 + i,
                              device="cpu")["tokens"][0]
            out.append(Request(uid=f"req{i}", tokens=toks.tolist(),
                               max_new_tokens=args.gen_tokens,
                               k=k_cycle[i % len(k_cycle)]))
        return out

    def stats_line(engine, tag):
        m = engine.metrics
        ttft = m.get("serve_ttft_steps")
        p50 = (f"{ttft.quantile(0.5):.0f}" if ttft is not None and ttft.count
               else "-")
        print(f"[{tag:>6}] step {engine.step_count:4d} | "
              f"queue {m.value('serve_queue_depth'):3.0f} "
              f"lanes {m.value('serve_lanes_active'):2.0f} | "
              f"tokens {m.value('serve_tokens_generated_total'):5.0f} | "
              f"live cache {m.value('kv_cache_live_bytes') / 1e6:6.2f} MB | "
              f"ttft p50 ~{p50} steps")

    def bench(engine, reqs, tag):
        if args.warmup:
            rep = engine.warmup(max_prompt_len=args.prompt_len)
            print(f"[{tag:>6}] warmup: {rep['census']['total']} graphs, "
                  f"{rep['captures']} captures in {rep['warmup_ms']:.0f} ms")
        t0 = time.perf_counter()
        if args.stats_every > 0:
            # step manually so the per-step gauges can be read mid-flight
            for r in reqs:
                engine.submit(r)
            comps0 = len(engine.completions)
            while not engine.done:
                engine.step()
                if engine.step_count % args.stats_every == 0:
                    stats_line(engine, tag)
            comps = engine.completions[comps0:]
        else:
            comps = engine.run(reqs)
        dt = time.perf_counter() - t0
        n_tok = sum(len(c.tokens) for c in comps)
        rep = engine.cache_report()
        print(f"[{tag:>6}] {len(comps)} reqs, {n_tok} tokens in "
              f"{dt * 1e3:7.1f} ms ({n_tok / dt:7.1f} tok/s, "
              f"{engine.step_count} steps) | cache {rep['bytes'] / 1e6:6.2f} MB"
              + (f" ({rep['saving']:.0%} saved)" if "saving" in rep else ""))
        print(f"[{tag:>6}] req0 tokens: {comps[0].tokens}")
        return comps

    dense = ServeEngine(cfg, params, **engine_kw)
    bench(dense, requests([None]), "dense")
    del dense

    if not args.no_swan:
        projections = calibrate_swan(api, cfg, params,
                                     make_batch(cfg, 4, 64, seed=3, device=dev))
        absorbed = api.absorb(params, cfg, projections)
        k_max = args.k or cfg.d_head // 2
        swan = SwanConfig(k_max=k_max, buffer=args.buffer, mode="topk",
                          quantize=args.quantize)
        eng = ServeEngine(cfg, absorbed, swan=swan, projections=projections,
                          **engine_kw)
        # per-request runtime-tunable compression: mix full and half k
        bench(eng, requests([k_max, max(k_max // 2, 1)]), "swan")
        print(f"        decode graphs for the mixed-k batch: "
              f"{eng.decode_cache_size} (none on an eager engine)")
        del eng
        if args.paged:
            pg = ServeEngine(cfg, absorbed, swan=swan,
                             projections=projections, paged=True,
                             page_size=args.page_size, **engine_kw)
            bench(pg, requests([k_max, max(k_max // 2, 1)]), "paged")
            rep = pg.cache_report()
            print(f"        paged: slab layout would reserve "
                  f"{rep['slab_bytes'] / 1e6:.2f} MB; pool live bytes "
                  f"followed generated tokens (now drained: "
                  f"{rep['live_pages']} pages)")


if __name__ == "__main__":
    main()
