#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. device   — the card's name and power limit (nvidia-smi) and torch's name.
2. build    — every CUDA kernel of the port, built from the sources in this
              checkout (one nvcc per source, all started together); each
              instance's registers and spills (ptxas) and its HMMA/HGMMA
              count (``cuobjdump -sass``): a tensor-core instance must
              spill nothing and hold tensor-core instructions, and no
              instance of the decode kernels (splits and merge) may spill.
3. kernels  — each kernel (slab and paged decode, slab and paged chunk
              stats, flash prefill, fused winnowing) against its plain
              PyTorch version on the card, at the shapes its main paths
              give it (the bench's k's, page buckets and full prefixes
              included) and at the edges of its tiling, for every value
              type it takes; paged == slab bit for bit, and two decode
              launches on the same inputs bit for bit; winnowing bit for
              bit under a signed-permutation rotation; its median time
              beside the plain version's, a PyTorch yardstick
              (``library_ms``) and the bound (the port's roofline:
              ``repro_torch/analysis/roofline.py``); for the decode
              kernels and winnowing also the host's µs per wrapper call
              and the device µs of their kernels (profiler).  Then B1-B4
              at the served archs' other query groups: yi-9b's (Kv 4, G 8),
              olmo-1b's (Kv 16, G 1), jamba's (Kv 8, G 8) and llama3-405b's
              (Kv 8, G 16: two launches of the G = 8 instance) at d_head
              128, internvl2-1b's (Kv 2, G 7) and whisper-small's (Kv 12,
              G 1) at d_head 64,
              every value type, chunks of 256 x G queries, each against
              its plain version and timed beside its bound; and B1/B2 at
              G in (3, 5, 6, 7, 12, 16), which the CUDA source has no
              instance of (``swan_decode.g_plan`` pads G with zero query
              rows up to the next instance and cuts G > 8 into groups),
              every value type, B2 == B1 bit for bit, timed at
              internvl2-1b's serve shape.
   bench    — the kernel microbenchmark
              (``repro_torch.benchmarks.bench_kernels.run()``) at full
              llama3-8b width: every kernel launched, every roofline row
              finite and positive, the H100 floors of B1–B6 met (launch
              counts zeroed just before).
4. serve    — llama3-8b at every width, 16 of its 32 layers (the
              script's time limit; bf16, seeded random weights) served
              through the lockstep SWAN path, eagerly (``graphs=False``):
              calibrate, absorb, ``ServeSession.generate``.  The kernel
              launch counts are zeroed just before ``generate`` and read
              just after.
5. exact    — 4 layers at full width, SWAN at full retention (k = d_head)
              against the dense-cache session: the decode logits must agree
              (Lemmas A.1/A.2), with the decode kernel on the path.
6. engine   — the same model through ``ServeEngine`` with chunked
              concurrent prefill, eagerly, on the slab and then on the
              paged pool: identical tokens, one launch of each layout's
              kernels per layer per dispatch (counts zeroed before each run, read
              after).
7. graphs   — the same model through CUDA graphs (``runtime.graphs``):
              the lockstep session graphed against eager in this call
              (prefill and first decode logits, tokens, ms/step, which
              must be at most 0.6 x eager; a profile whose B1 executions
              are one per layer per step); the engine graphed on the slab and the
              paged pool after ``warmup(max_prompt_len=2048)`` (census
              at or above ``expected`` in every bucket), serving the
              engine trace with the eager runs' tokens, dispatches and
              ``cache_report()`` and one launch per layer per dispatch counted
              through the replays (paged with ``async_fetch=True``); then
              on the slab a shuffled mixed trace that must capture no
              graph; on each layout a profile of graphed engine steps
              (B1 and B3, or B2 and B4, executed once per layer per dispatch;
              a short window is held against the per-replay records and
              another is traced); last, monolithic admission
              graphed without a warmup (prefill and insert graphs captured
              at first use) against eager, slab and paged.  Warmup seconds,
              graph counts, graph memory, and eager vs graphed step times.
              The graphed engines run instrumented (``repro_torch.obs``):
              their warmup's captures in ``serve_compile_total{phase=
              "warmup"}``, none in ``{phase="serve"}`` over the trace, the
              ``kv_cache_*`` gauges equal to ``cache_report()``; the eager
              baselines run with ``metrics=False``.  Each warmed engine
              then serves the trace with metrics off, on, on, off: the
              same tokens and dispatches, and graphed step ms with
              metrics on and off.
   sharded  — the engine over ``make_serve_mesh(2, devices=["cuda:0"] *
              2)``: two data shards of 2 slots laid over the one card, the
              engine trace at the engine phase's sizes.  64-token pages
              graphed after ``warmup(max_prompt_len=2048)`` (census at or
              above ``expected``; a mixed trace then captures nothing),
              the slab graphed at first use, the pages again eagerly:
              paged == slab tokens, graphed == eager (tokens, dispatches,
              ``cache_report()``), at most one chunk and one decode
              dispatch per step, B2/B4 (pages) and B1/B3 (slab) once per
              layer per dispatch through the replays (not once per
              shard), per-shard reports summing to the totals and equal
              to the per-shard gauges, the pool consistent and drained;
              dp = 2's tokens against dp = 1's
              (``repro_torch.benchmarks.parity``: where they part, the two
              runs' logits of the two tokens they chose agree within
              5e-2 and dp = 1's top-two margin is below it; every shared
              token's whole logits row within ``ROW_TOL``), beside a dp =
              1 run at dp = 2's chunk lane counts that dp = 2 must equal
              bit for bit, and a control with shard 1's lane offset
              dropped that must fail the whole-row limit; the serve
              auditor's ``paged-dp2`` row over the warmed engine (in the
              audit phase when that runs).  Step times against dp = 1's.
   audit    — the serve auditor (``repro_torch.analysis.lint.audit.
              run_audit``) over the graphs phase's two warmed engines
              (their graph descriptions kept; warmed here under ``--only
              audit``) and the sharded phase's, and three eager engines
              (slab, pages, pages over two shards) whose SWAN reads take the
              plain PyTorch path on the card: every decode graph holds one
              B1 (slab) or B2 (pages) split + merge node pair per layer and
              every chunk graph one B3 or B4 node per layer (CUDA's DOT
              description of each
              graph and the wrappers' capture tallies agree), no graph a
              device-to-host memcpy, a host node or an NCCL kernel; a
              second warmup and a mixed trace capture nothing; each
              engine step blocks the host only at the token fetch (cost
              analyzer + CUDA sync debug mode); the kernel prechecks pass
              at the engine's shapes; the logical-view detector passes on
              the paged kernel path and trips on the plain path.  Every
              check printed as JSON.  Then the lockstep cell's decode step
              and 4 x 2048 prefill counted by the cost analyzer (eager) and
              timed graphed: their roofline rows
              (``analysis.report.roofline_table``) with the card's name
              and power limit.
8. dense   — yi-9b (d_model 4096, 32/4 heads: G = 8; 12 of its 48
              layers: the script's time limit), olmo-1b (16 layers,
              d_model 2048, 16/16 heads: G = 1, non-parametric LayerNorm,
              tied embeddings) and llama3-405b (d_model 16384, 128/8
              heads: G = 16, d_ff 53248, vocab 128256; 2 of its 126
              layers: 10.58 B params, 21.2 GB) at full width, bf16, seeded
              weights, each after the previous model is freed: calibrate,
              absorb, the lockstep session eager and graphed (logits bit
              for bit or within 5e-2, tokens equal, B1 once per layer per
              step through the replays, twice at G = 16 (two groups of
              8), a graphed step at most 1/20 of an eager one's aten ops
              and, but for llama3-405b's weight-bound step (the ratio
              logged), at most 0.6 x its ms; device memory peaks); the
              engine trace eagerly on the slab (B1, B3) and
              graphed at first use on the paged pool with ``async_fetch``
              (B2, B4): equal tokens and dispatches, each layout's kernels
              once per layer per dispatch (B1/B2 twice at G = 16; plus
              each capture's warm run); then 4 layers (llama3-405b: its 2)
              at full retention against the dense cache (decode; two-chunk
              prefill, slab and paged).  Seconds per part printed.
   moe     — deepseek-moe-16b (64 routed experts, top-6, 2 shared) and
              qwen2-moe-a2.7b (60 routed, top-4, 4 shared, q/k/v biases
              seeded N(0, 0.02)), both d_model 2048 and 16/16 heads
              (G = 1), at full width and half depth (14 of 28 and 12 of
              24 layers: the script's time limit), bf16,
              seeded weights, after the dense phase's models are freed:
              the dense phase's lockstep, engine and full-retention checks
              through the MoE FFN (``models.moe``).  The lockstep prefill
              of 4 x 2048 tokens passes the 4096-assignment no-drop limit
              (its capacity follows the doubled capacity factor); the
              engine's chunk and decode dispatches and the full-retention
              prompts stay under it, so nothing there is dropped.
              Parameter counts, peak memory and seconds per part printed.
   vlm     — internvl2-1b (24 layers, d_model 896, 14/2 heads: G = 7,
              q/k/v biases seeded N(0, 0.02)) at full width and depth,
              bf16, seeded weights, SwanConfig(k_max=32, buffer=128): the
              lockstep session over 256 patch embeddings + a 2048-token
              prompt, eager and graphed (logits bit for bit, the session
              continuing at the prefill's full length); the engine trace
              (token prompts) eager on the slab and graphed at first use
              on the paged pool; 4 layers at full retention against the
              dense cache.
   encdec  — whisper-small (12 + 12 layers, d_model 768, 12/12 heads,
              every bias seeded N(0, 0.02)) at full width and depth,
              bf16: the lockstep session (the reference serves it
              lockstep only) over 1500 frames, a 384-token prompt and 64
              new tokens, eager and graphed, with the static cross cache
              dense and then winnowed (``compress_cross_attn``); B1 once
              per decoder layer per step (G = 1); then in float32 at 4
              decoder layers, full retention against the dense
              self-attention cache and the winnowed cross cache against
              the dense one (2e-4 abs + 1e-3 rel, the reference's test).
   hybrid  — jamba-1.5-large-398b at every published width (d_model
              8192, 64/8 heads: G = 8, d_ff = d_expert 24576, Mamba d_state
              16, d_conv 4, expand 2, vocab 65536), cut to one of its nine
              groups (8 layers: attention at 4, MoE at 1, 3, 5, 7) and 4 of
              its 16 routed experts (top-2 kept): 16.247 B params, bf16,
              seeded weights, SwanConfig(k_max=64, buffer=128), calibrated
              and absorbed.  The lockstep session (batch 4, 2048-token
              prompt, 64 new tokens) eager and graphed: logits bit for
              bit, tokens equal, B1 once per attention layer per step; the
              engine trace (k = 64 for every request: the family takes no
              per-request k) monolithically on the slab, eagerly; full
              retention (k = d_head) against the dense cache in bf16
              (batch 2, reported); then in
              float32 with 2 routed experts of top-2 (11.41 B params:
              routing cannot flip) full retention against the dense cache
              within 1e-3 of the logits' scale, and one Mamba layer's
              chunked prefill against its token recurrence (the reference
              test's 1e-5).  Parameters, weight bytes read per decode step,
              Eq. 1 cache, recurrent state bytes, peak memory and seconds.
   ssm     — rwkv6-3b at full width, 16 of its 32 layers (d_model 2560,
              40 heads x 64, d_ff 8960), bf16, no SWAN: the lockstep
              session as in the hybrid phase, the engine trace eager and
              graphed at first use (one prefill graph per prompt length;
              tokens, dispatches and cache report equal) — no kernel runs:
              every count stays 0; in float32 prefill then
              decode against the forward's logits at the same positions
              and one layer's chunked wkv against its recurrence (the
              reference tests' tolerances).  Both parameter counts, state
              bytes, step times and memory.
9. chunk_exact — 4 layers at full retention: a prompt prefilled in two
              chunks (slab, paged) against the dense monolithic prefill.
10. obs     — the launcher (``repro_torch.launch.serve.main``) serving
              llama3-8b on the paged pool with chunked prefill, graphed
              without a warmup (buckets captured at first use), with
              ``--metrics-out``, ``--trace-out`` and ``--profile-steps
              4``: the Prometheus file parses, its token count, the
              trace's first-token and retire events and its mid-serve
              captures agree with the engine, and the profile holds the
              B2 and B4 records of the window's graph replays (up to
              three runs: none may count more than 32 x the window's
              dispatches, one must count exactly).  Then the graphed step
              ms of the graphs phase with metrics on and off.
11. train   — the decode kernel against its plain version at the quality
              benches' shapes (B=8, Kv=2, G=2, dh=32, b=8, f32 queries,
              f32 and int8 values, k from 1 to 32, sp_len 0 to 228; two
              launches bit for bit); llama3-8b's widths cut to 4 of its 32
              layers (bf16 params, f32 AdamW moments, remat, 2
              microbatches, global batch 8 x 512) trained 12 steps
              straight and 6 + an async checkpoint + a fresh Trainer's
              resume to 12 (the step-6 save the only one written: the
              runs' final saves are skipped): finite, falling losses, the
              resumed ones equal
              to the straight run's (bit for bit or within 1e-3), ms/step,
              tokens/s, peak memory and MFU printed; then the quality
              benchmarks' tiny LM trained 900 steps on the card (f32, TF32
              off), calibrated and scored by the six benches' ``run()``
              (Tables 1-3, Fig. 2b, Fig. 4, adaptive k): every NLL and
              logit error finite, Table 1's full-retention row within 1e-3
              of dense, the decode kernel launched in the buffered benches
              and not at ``buffer=0`` (counts zeroed before each bench).

After the train phase the port's bench harness folds the bench and train
phases' artifacts into ``build/bench_out/BENCH_SUMMARY_torch.json``
(``repro_torch.benchmarks.run.aggregate``): every artifact ok, no gate
failed, its tally printed.

The last three lines are nvidia-smi's name and power limit of the card,
one JSON object of kernel numbers (``launches`` summed over the main paths
that ran the kernel — the bench, the lockstep serve, the engines, graphed
and eager, the dense, MoE, VLM, encoder-decoder and hybrid phases' models,
the quality benches — and
``launches_by_path`` per path), and the result line
``{"ok": true, "device": {...}}``; the ``[done]`` line before them gives
each phase's seconds.  Without a CUDA device it exits non-zero and prints
no result.
"""
from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# the serve phase's shapes (llama3-8b, SwanConfig(k_max=64, buffer=128))
B, KV, G, DH, K, BUF, S = 4, 8, 4, 128, 64, 128, 4096
PROMPT, NEW_TOKENS = 2048, 64
VLM_PREFIX = 256                 # internvl2-1b's patch embeddings


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def groups(cfg):
    """B1/B2 launches per attention layer per decode step: the groups of
    ``swan_decode.g_plan`` for the config's query group (2 at llama3-405b's
    G = 16, else 1); B3/B4 launch once per layer per chunk."""
    from repro_torch.analysis.lint.audit import decode_groups
    return decode_groups(cfg)


def bound_of(label, ms, nbytes, flops):
    """The port's roofline row for a launch of ``ms`` that moves ``nbytes``
    device bytes and does ``flops`` operations: (bound ms, "bytes" or
    "operations")."""
    from repro_torch.analysis.roofline import roofline_row
    row = roofline_row(label, ms * 1e3, nbytes, flops)
    return row["floor_us"] / 1e3, ("bytes" if row["bound"] == "memory"
                                   else "operations")


def flush_buffer():
    """A device buffer larger than L2: zeroing it before a timed launch
    makes that launch start cold."""
    import torch
    from repro_torch.benchmarks.common import L2_FLUSH_BYTES
    return torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")


# ---------------------------------------------------------------------------
# phase 3: swan_decode against its plain version
# ---------------------------------------------------------------------------

def ring_positions(pos, b):
    """buf_pos [B, b] of a ring that holds positions max(p-b+1, 0)..p."""
    import torch
    bp = torch.full((len(pos), b), -1, dtype=torch.int32)
    for i, p in enumerate(pos):
        for t in range(max(p - b + 1, 0), p + 1):
            bp[i, t % b] = t
    return bp.cuda()


def decode_inputs(kind: str, pos, gen, k=K, g=G, dh=DH, kv=KV):
    """Operands of one decode read at the serve shapes (``kv`` heads of
    ``g`` queries and ``dh`` columns where given), ``k`` packed entries per
    row.  kind: value storage (bf16 / int8 / fp8 with bf16 q, or f32
    throughout)."""
    import torch
    qdt = torch.float32 if kind == "f32" else torch.bfloat16
    dev = "cuda"
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    idx = lambda: torch.rand((B, kv, S, dh), generator=gen, device=dev
                             ).argsort(-1)[..., :k].to(torch.int8)
    a = {"q": rnd(B, kv, g, dh).to(qdt), "k_idx": idx(), "v_idx": idx(),
         "buf_k": rnd(B, kv, BUF, dh).to(qdt), "buf_v": rnd(B, kv, BUF, dh).to(qdt),
         "buf_pos": ring_positions(pos, BUF),
         "pos": torch.tensor(pos, dtype=torch.int32, device=dev)}
    a["sp_len"] = torch.clamp(a["pos"] + 1 - BUF, min=0).to(torch.int32)
    for s in "kv":
        if kind == "int8":
            a[f"{s}_vals"] = torch.randint(-127, 128, (B, kv, S, k), generator=gen,
                                           device=dev).to(torch.int8)
            a[f"{s}_scale"] = rnd(B, kv, S).abs() * 0.05 + 0.01
        elif kind == "fp8":
            a[f"{s}_vals"] = rnd(B, kv, S, k).to(torch.float8_e4m3fn)
        else:
            a[f"{s}_vals"] = rnd(B, kv, S, k).to(qdt)
    return a


ARGS = ("q", "k_vals", "k_idx", "v_vals", "v_idx", "buf_k", "buf_v",
        "buf_pos", "pos", "sp_len")


def call(fn, a):
    return fn(*[a[n] for n in ARGS], k_scale=a.get("k_scale"),
              v_scale=a.get("v_scale"))


def decode_bytes_flops(a):
    """Bytes the function must move (each input once, the output once;
    sparse rows counted only below sp_len) and its float operations."""
    B_, Kv_, G_, dh_ = a["q"].shape
    rows, k = int(a["sp_len"].sum()) * Kv_, a["k_vals"].shape[-1]
    per_row = 2 * k * (a["k_vals"].element_size() + 1)
    if "k_scale" in a:
        per_row += 2 * 4
    ring = sum(a[n].numel() * a[n].element_size()
               for n in ("buf_k", "buf_v", "buf_pos"))
    qo = 2 * a["q"].numel() * a["q"].element_size()
    valid_slots = int(((a["buf_pos"] >= 0)
                       & (a["buf_pos"] <= a["pos"][:, None])).sum()) * Kv_
    flops = 4 * G_ * (rows * k + valid_slots * dh_)
    return rows * per_row + ring + qo + 8 * B_, flops


def dense_expand(vals, idx, scale, dh=DH):
    """Dense f32 [..., rows, dh] form of packed values (times the per-row
    scale where there is one), for the SDPA yardsticks."""
    import torch
    v = vals.float() if scale is None else vals.float() * scale[..., None]
    out = torch.zeros(tuple(idx.shape[:-1]) + (dh,), device=idx.device)
    return out.scatter_(-1, idx.long(), v)


def sdpa_yardstick(a):
    """The same function as one scaled_dot_product_attention call over the
    dense-expanded [sparse ‖ ring] keys/values (expansion done here, outside
    the timed call).  Returns (closure, output)."""
    import torch
    import torch.nn.functional as F

    B_, Kv_, G_, dh_ = a["q"].shape
    kd = dense_expand(a["k_vals"], a["k_idx"], a.get("k_scale"), dh_)
    vd = dense_expand(a["v_vals"], a["v_idx"], a.get("v_scale"), dh_)
    qdt = a["q"].dtype
    k_all = torch.cat([kd, a["buf_k"].float()], 2).to(qdt)
    v_all = torch.cat([vd, a["buf_v"].float()], 2).to(qdt)
    k_all = k_all.repeat_interleave(G_, dim=1).contiguous()  # [B, H, S+b, dh]
    v_all = v_all.repeat_interleave(G_, dim=1).contiguous()
    q = a["q"].reshape(B_, Kv_ * G_, 1, dh_)
    t = torch.arange(a["k_vals"].shape[2], device="cuda")
    mask = torch.cat([t[None] < a["sp_len"][:, None],
                      (a["buf_pos"] >= 0) & (a["buf_pos"] <= a["pos"][:, None])],
                     1)[:, None, None, :]                       # [B,1,1,S+b]
    fn = lambda: F.scaled_dot_product_attention(q, k_all, v_all, attn_mask=mask)
    return fn, fn().reshape(B_, Kv_, G_, dh_)


def bench_shapes():
    """The kernel bench's full-width shapes (its decode k's and page
    buckets are checked here too)."""
    from repro_torch.benchmarks.bench_kernels import shapes
    sh = shapes(smoke=False)
    check(sh.page_size == PS and sh.dec_S == S and sh.dec_buffer == BUF
          and sh.chunk_S == CS and sh.chunk_k == K,
          "the bench's shapes left the ones checked here")
    return sh


def decode_check(kind, case, a, tol, max_err):
    """B1 against its plain twin (tolerance ``tol`` abs+rel), against
    itself (a second launch: identical bits) and, through a shuffled
    64-row page pool, against B2 (identical bits)."""
    import torch
    from repro_torch.kernels.swan_decode.swan_decode import (
        swan_decode, swan_decode_paged, swan_decode_plain)
    got = call(swan_decode, a)
    again = call(swan_decode, a)
    want = call(swan_decode_plain, a).float()
    torch.cuda.synchronize()
    err = (got.float() - want).abs()
    same = torch.equal(got, again)
    shape = f"k={a['k_vals'].shape[-1]} G={a['q'].shape[2]} dh={a['q'].shape[3]}"
    msg = (f"  swan_decode[{kind:4s}] {shape} {case}: max_abs_err "
           f"{err.max().item():.3e} (tol {tol:g} abs+rel); 2 launches equal: {same}")
    check(bool(torch.isfinite(got).all()) and not bool((err > tol * (1 + want.abs())).any()),
          f"swan_decode[{kind}] {shape} {case}: kernel disagrees with plain")
    check(same, f"swan_decode[{kind}] {shape} {case}: two launches differ")
    names = [n for n in ("k_vals", "k_idx", "v_vals", "v_idx", "k_scale",
                         "v_scale") if n in a]
    sp = [int(x) for x in a["sp_len"].tolist()]
    pool, tab = page_out(a, sp, torch.Generator(device="cuda").manual_seed(5),
                         names, B)
    paged = swan_decode_paged(
        a["q"], pool["k_vals"], pool["k_idx"], pool["v_vals"], pool["v_idx"],
        *[a[n] for n in ARGS[5:]], tab, pool_k_scale=pool.get("k_scale"),
        pool_v_scale=pool.get("v_scale"))
    torch.cuda.synchronize()
    same = torch.equal(paged, got)
    msg += f"; == swan_decode_paged: {same}"
    check(same, f"swan_decode[{kind}] {shape} {case}: != swan_decode_paged")
    log(msg)
    max_err[kind] = max(max_err.get(kind, 0.0), err.max().item())


def kernel_phase():
    import torch
    from repro_torch.kernels.swan_decode.swan_decode import (SPLIT_ROWS,
                                                             swan_decode,
                                                             swan_decode_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tol = {"f32": 1e-5, "bf16": 1e-2, "int8": 1e-2, "fp8": 1e-2}
    R = SPLIT_ROWS
    cases = {
        "sp_len=0, ring part filled": [0, 5, 60, BUF - 1],
        "per-sequence pos": [PROMPT + NEW_TOKENS - 2, 1000, 3000, S - 7],
        "bench pos (sp_len 3960)": [S - 9] * B,
        "full-length prefix": [S + BUF - 1] * B,
        # the split edges (sp_len R-1, R, R+1) and a one-row prefix
        "sp_len R-1 / R / R+1 / 1": [n + BUF - 1 for n in (R - 1, R, R + 1, 1)],
    }
    max_err = {}
    # the serve and bench k's, and the edges of the tiling: k=1, k=20 (rows
    # of 20-byte indices, 4-byte aligned), k=48, k=dh
    for k in sorted({K, *bench_shapes().dec_ks, 1, 20, 48, DH}):
        for kind in ("bf16", "int8", "fp8", "f32"):
            for case, pos in cases.items():
                decode_check(kind, case, decode_inputs(kind, pos, gen, k), tol[kind],
                             max_err)
    # other query groups at small widths (dh=20: ring rows not 16-byte vectors)
    for g, dh, k in ((1, 64, 32), (2, 20, 12), (8, 64, 64), (8, 20, 20)):
        for kind in ("bf16", "int8", "fp8", "f32"):
            for case in ("per-sequence pos", "sp_len R-1 / R / R+1 / 1"):
                decode_check(kind, case, decode_inputs(kind, cases[case], gen, k, g, dh),
                             tol[kind], max_err)

    # timing at the serve phase's last decode step (lockstep, bf16 values)
    from repro_torch.benchmarks.common import time_ms
    flush = flush_buffer()
    rows = {}
    for kind in ("bf16", "int8", "fp8"):
        a = decode_inputs(kind, [PROMPT + NEW_TOKENS - 2] * B, gen)
        nbytes, flops = decode_bytes_flops(a)
        ms = time_ms(lambda: call(swan_decode, a), 50, flush)
        bound, by = bound_of(f"swan_decode[{kind}]", ms, nbytes, flops)
        plain_ms = time_ms(lambda: call(swan_decode_plain, a), 10, flush)
        lib_fn, lib_out = sdpa_yardstick(a)
        lib_err = (lib_out.float() - call(swan_decode_plain, a).float()).abs().max()
        lib_ms = time_ms(lib_fn, 20, flush)
        log(f"  swan_decode[{kind:4s}] serve shape (sp_len "
            f"{int(a['sp_len'][0])}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms (expansion excluded; |sdpa-plain| "
            f"{lib_err.item():.2e}), bound {bound:.4f} ms ({nbytes} B, "
            f"{100 * bound / ms:.1f}% of bound)")
        log_host_device(f"swan_decode[{kind:4s}]", lambda: call(swan_decode, a),
                        a, flush, S)
        rows[kind] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by, "library_ms": lib_ms}
    del flush
    return max_err, rows


# ---------------------------------------------------------------------------
# phase 3 (cont.): swan_decode_paged, swan_chunk_stats(_paged)
# ---------------------------------------------------------------------------

PS, PG = 64, S // 64             # the engine's page size, pages per sequence
N_PAGES = -(-(B * PG + 1) // 8) * 8      # the engine's default pool (+ trash)


def garbage_like(shape, dtype, gen):
    """Random content for pool pages no sequence maps (the trash page and
    free pages): a kernel that reads them produces visible errors."""
    import torch
    if dtype == torch.int8:
        return torch.randint(-128, 128, shape, generator=gen, device="cuda"
                             ).to(torch.int8)
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def page_out(a, sp, gen, names, lanes, pg=PG, n_pages=N_PAGES, ps=PS):
    """Copy each lane's first ceil(sp / ps) logical pages of the slab
    leaves ``a[name]`` [lanes, Kv, pg*ps, ...] into shuffled physical pages
    of a pool full of garbage.  Returns (pool leaves, page table [lanes,
    pg] int32 with every unmapped entry on trash page 0)."""
    import torch
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(7)) + 1
    tab = torch.zeros((lanes, pg), dtype=torch.int32)
    used = 0
    for i, n in enumerate(sp):
        m = -(-n // ps)
        tab[i, :m] = perm[used:used + m]
        used += m
    pool = {}
    for n in names:
        x = a[n]
        kv, tail = x.shape[1], tuple(x.shape[3:])
        bits = lambda t: t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t
        shape = (n_pages, kv, ps) + tail
        pool[n] = (torch.randint(0, a["q"].shape[-1], shape, generator=gen,
                                 device="cuda").to(torch.int8) if n.endswith("idx")
                   else garbage_like(shape, x.dtype, gen))
        for i, spn in enumerate(sp):
            m = -(-spn // ps)
            if m:
                rows = x[i, :, :m * ps].reshape(kv, m, ps, *tail).transpose(0, 1)
                bits(pool[n])[tab[i, :m].long().cuda()] = bits(rows)
    return pool, tab.cuda()


def timed_rows(label, fn, plain_fn, lib_fn, nbytes, flops, flush,
               lib_label="sdpa (expansion excluded)"):
    """Median kernel, plain and library times (ms) and the bound."""
    from repro_torch.benchmarks.common import time_ms
    ms = time_ms(fn, 30, flush)
    bound, by = bound_of(label, ms, nbytes, flops)
    plain_ms = time_ms(plain_fn, 5, flush)
    lib_ms = time_ms(lib_fn, 10, flush)
    log(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, {lib_label} "
        f"{lib_ms:.4f} ms, bound {bound:.4f} ms by {by} "
        f"({nbytes} B, {flops:.3e} op; {100 * bound / ms:.2f}% of bound)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms}


def host_device_us(fn, flush, kernel, ws_bytes=0, n=50):
    """Per call of a kernel wrapper ``fn``: the host's µs to issue it
    (``n`` calls back to back, the card left to run behind), the device µs
    of the kernels whose names hold ``kernel`` (torch.profiler, L2 flushed
    before each call), and the host's µs for one ``torch.empty`` of its
    ``ws_bytes`` workspace (None for a wrapper without one)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def host(f):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            f()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / n * 1e6

    host_us = host(fn)
    ws_us = (host(lambda: torch.empty(ws_bytes // 4, dtype=torch.float32,
                                      device="cuda")) if ws_bytes else None)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and kernel in e.key) / n
    return host_us, dev_us, ws_us


def log_host_device(label, fn, a, flush, S):
    from repro_torch.kernels.swan_decode.swan_decode import workspace_bytes
    B_, Kv_, G_, dh_ = a["q"].shape
    host_us, dev_us, ws_us = host_device_us(
        fn, flush, "swan_decode_", workspace_bytes(B_, Kv_, G_, dh_, S))
    log(f"  {label}: host {host_us:.1f} us per wrapper call (of which "
        f"{ws_us:.1f} us the workspace's torch.empty), device {dev_us:.1f} us "
        f"per call (split + merge kernels, profiler)")


def paged_decode_phase():
    """B2 against its plain twin, against itself (a second launch) and,
    bit for bit, against B1 on the same logical rows, at the engine's pool
    (64-row pages), at 16-row pages and at the bench's k's and page
    buckets; then its time at the serve shape."""
    import torch
    from repro_torch.kernels.swan_decode.swan_decode import (
        SPLIT_ROWS, swan_decode, swan_decode_paged, swan_decode_paged_plain)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tol = {"f32": 1e-5, "bf16": 1e-2, "int8": 1e-2, "fp8": 1e-2}
    names = ("k_vals", "k_idx", "v_vals", "v_idx", "k_scale", "v_scale")
    max_err, rows = {}, {}

    def paged_case(kind, case, sp, k=K, pg=PG, n_pages=N_PAGES, ps=PS):
        pos = [n + BUF - 1 if n else 60 for n in sp]
        a = decode_inputs(kind, pos, gen, k)
        pool, tab = page_out(a, sp, gen, [n for n in names if n in a], B,
                             pg=pg, n_pages=n_pages, ps=ps)
        pargs = ([a["q"], pool["k_vals"], pool["k_idx"], pool["v_vals"],
                  pool["v_idx"]] + [a[n] for n in ARGS[5:]] + [tab])
        pkw = {"pool_k_scale": pool.get("k_scale"),
               "pool_v_scale": pool.get("v_scale")}
        got = swan_decode_paged(*pargs, **pkw)
        again = swan_decode_paged(*pargs, **pkw)
        want = swan_decode_paged_plain(*pargs, **pkw).float()
        slab = call(swan_decode, a)
        torch.cuda.synchronize()
        err = (got.float() - want).abs()
        same, same2 = torch.equal(got, slab), torch.equal(got, again)
        log(f"  swan_decode_paged[{kind:4s}] k={k} {pg} pages/seq of {ps} rows, "
            f"{n_pages} in the pool, {case}: max_abs_err {err.max().item():.3e} "
            f"(tol {tol[kind]:g} abs+rel); == swan_decode bit for bit: {same}; "
            f"2 launches equal: {same2}")
        check(bool(torch.isfinite(got).all())
              and not bool((err > tol[kind] * (1 + want.abs())).any()),
              f"swan_decode_paged[{kind}] k={k} {case}: kernel disagrees with plain")
        check(same, f"swan_decode_paged[{kind}] k={k} {case}: != swan_decode")
        check(same2, f"swan_decode_paged[{kind}] k={k} {case}: two launches differ")
        max_err[kind] = max(max_err.get(kind, 0.0), err.max().item())
        return a, pargs, pkw, tab

    # the bench's operands: each of its k's and page buckets (pb pages per
    # sequence, a pool of B·pb + 1 pages), every bucket full
    sh = bench_shapes()
    for k in sh.dec_ks:
        for pb in sh.page_buckets:
            paged_case("bf16", f"bench, sp_len {pb * PS}", [pb * PS] * B, k,
                       pb, B * pb + 1)
            paged_case("bf16", "sp_len 0 / mid-page / full / 1983",
                       [0, 1000, pb * PS, 1983], k, pb, B * pb + 1)
    R = SPLIT_ROWS
    sp_cases = {"sp_len 0 / mid-page / full / 1983": [0, 1000, S, 1983],
                "sp_len R-1 / R / R+1 / 1": [R - 1, R, R + 1, 1],
                "serve shape, sp_len 1983": [1983] * B}
    # 16-row pages: a table of S/16 entries over a pool of B·S/16 + 1 pages
    for kind in ("bf16", "int8", "fp8", "f32"):
        for case, sp in sp_cases.items():
            paged_case(kind, case, sp, pg=S // 16, n_pages=B * (S // 16) + 1, ps=16)
    flush = flush_buffer()
    for kind in ("bf16", "int8", "fp8", "f32"):
        for case, sp in sp_cases.items():
            a, pargs, pkw, tab = paged_case(kind, case, sp)
            if kind != "f32" and case.startswith("serve"):
                nbytes, flops = decode_bytes_flops(a)
                nbytes += tab.numel() * 4
                lib_fn, _ = sdpa_yardstick(a)
                label = f"swan_decode_paged[{kind:4s}]"
                rows[kind] = timed_rows(
                    f"{label} serve shape (sp_len 1983)",
                    lambda: swan_decode_paged(*pargs, **pkw),
                    lambda: swan_decode_paged_plain(*pargs, **pkw), lib_fn,
                    nbytes, flops, flush)
                log_host_device(label, lambda: swan_decode_paged(*pargs, **pkw),
                                a, flush, tab.shape[1] * PS)
    del flush
    return max_err, rows["bf16"]


# the chunk phase's shapes: P lanes of one full chunk (256 tokens x G) over
# a slab prefix bucket of CS rows (CPG pages)
P_CHUNK, Q_CHUNK, CS = 2, 256 * G, 2048
CPG = CS // PS


def chunk_inputs(kind, sp, gen, q_len=Q_CHUNK, k=K, kv=KV, dh=DH):
    """Operands of one chunk-stats read: f32 q [P, kv, q_len, dh], packed
    slab [P, kv, CS, k] (+ scales), sp_len [P]."""
    import torch
    dev = "cuda"
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    idx = lambda: torch.rand((P_CHUNK, kv, CS, dh), generator=gen, device=dev
                             ).argsort(-1)[..., :k].to(torch.int8)
    a = {"q": rnd(P_CHUNK, kv, q_len, dh), "k_idx": idx(), "v_idx": idx(),
         "sp_len": torch.tensor(sp, dtype=torch.int32, device=dev)}
    vdt = {"bf16": torch.bfloat16, "f32": torch.float32,
           "fp8": torch.float8_e4m3fn, "int8": torch.int8}[kind]
    for s_ in "kv":
        a[f"{s_}_vals"] = garbage_like((P_CHUNK, kv, CS, k), vdt, gen)
        if kind == "int8":
            a[f"{s_}_scale"] = rnd(P_CHUNK, kv, CS).abs() * 0.05 + 0.01
    return a


def chunk_bytes_flops(a):
    """Bytes (valid packed rows of both sides, q, sp_len, the three outputs)
    and operations of one chunk-stats read: a sparse product, so 4·Q·k per
    valid row and kv head (q·k over the k stored entries, p·v into them)."""
    P_, Kv_, Q_, dh_ = a["q"].shape
    k = a["k_vals"].shape[-1]
    rows = int(a["sp_len"].sum()) * Kv_
    per_row = 2 * k * (a["k_vals"].element_size() + 1)
    if "k_scale" in a:
        per_row += 2 * 4
    q_b = a["q"].numel() * 4
    out_b = P_ * Kv_ * Q_ * (2 + dh_) * 4
    flops = 4 * Q_ * k * rows
    return rows * per_row + q_b + out_b + 4 * P_, flops


def chunk_sdpa_yardstick(a):
    """One scaled_dot_product_attention call over the dense-expanded bf16
    prefix with the sp_len mask (expansion excluded)."""
    import torch
    import torch.nn.functional as F

    dh = a["q"].shape[-1]
    kd = dense_expand(a["k_vals"], a["k_idx"], a.get("k_scale"), dh).bfloat16()
    vd = dense_expand(a["v_vals"], a["v_idx"], a.get("v_scale"), dh).bfloat16()
    q = a["q"].bfloat16()
    mask = (torch.arange(CS, device="cuda")[None] < a["sp_len"][:, None]
            )[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask)


CHUNK_TOL = {"f32": 1e-5, "bf16": 1e-4, "int8": 1e-4, "fp8": 1e-4}
CHUNK_NAMES = ("k_vals", "k_idx", "v_vals", "v_idx", "k_scale", "v_scale")


def chunk_check(kind, case, a, gen, max_err):
    """B3 and B4 against their plain twins on ``a``, B4 == B3 bit for bit
    on the same logical rows (a shuffled page pool), empty lanes (0, 0,
    0).  A case named "dead" gives lane 1 lane 0's pages.  Returns the
    slab and paged arguments for timing."""
    import torch
    from repro_torch.kernels.swan_chunk.swan_chunk import (
        swan_chunk_stats, swan_chunk_stats_paged, swan_chunk_stats_paged_plain,
        swan_chunk_stats_plain)
    sp = [int(x) for x in a["sp_len"].tolist()]
    pool, tab = page_out(a, sp, gen, [n for n in CHUNK_NAMES if n in a],
                         P_CHUNK, pg=CPG)
    if "dead" in case:        # a dead lane reads a live lane's pages
        tab[1] = tab[0]
    sargs = [a[n] for n in ("q", "k_vals", "k_idx", "v_vals", "v_idx",
                            "sp_len")]
    skw = {"k_scale": a.get("k_scale"), "v_scale": a.get("v_scale")}
    pargs = [a["q"], pool["k_vals"], pool["k_idx"], pool["v_vals"],
             pool["v_idx"], a["sp_len"], tab]
    pkw = {"pool_k_scale": pool.get("k_scale"),
           "pool_v_scale": pool.get("v_scale")}
    slab = swan_chunk_stats(*sargs, **skw)
    paged = swan_chunk_stats_paged(*pargs, **pkw)
    want = swan_chunk_stats_plain(*sargs, **skw)
    want_p = swan_chunk_stats_paged_plain(*pargs, **pkw)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(slab, paged))
    m, l, o = slab
    wm, wl, wo = want
    live = wl > 0
    on = lambda x, y: (x / y.clamp(min=1e-30)[..., None])  # noqa: E731
    errs = {"m_safe": (m - wm).abs(), "l": (l - wl).abs() / (1 + wl.abs()),
            "o/l": (on(o, l) - on(wo, wl))[live].abs()}
    errs["o/l"] = errs["o/l"] / (1 + on(wo, wl)[live].abs())
    err = max(e.max().item() if e.numel() else 0.0 for e in errs.values())
    twin_same = all(torch.equal(x, y) for x, y in zip(want, want_p))
    empty = (a["sp_len"] == 0)
    zeros = all(not bool(x[empty].any()) for x in slab)
    tol = CHUNK_TOL[kind]
    log(f"  swan_chunk_stats[{kind:4s}] {case}: max err (abs+rel over "
        f"m_safe, l, o/l) {err:.3e} (tol {tol:g}); paged == slab "
        f"bit for bit: {same}; empty lanes (0, 0, 0): {zeros}")
    check(all(bool(torch.isfinite(x).all()) for x in slab + paged)
          and err <= tol and zeros and twin_same,
          f"swan_chunk_stats[{kind}] {case}: kernel disagrees with plain")
    check(same, f"swan_chunk_stats_paged[{kind}] {case}: != swan_chunk_stats")
    max_err[kind] = max(max_err.get(kind, 0.0), err)
    return sargs, skw, pargs, pkw, tab


def chunk_timed_rows(label, a, sargs, skw, pargs, pkw, tab, flush):
    """B3 and B4 timed on the same operands (slab, then paged)."""
    from repro_torch.kernels.swan_chunk.swan_chunk import (
        swan_chunk_stats, swan_chunk_stats_paged, swan_chunk_stats_paged_plain,
        swan_chunk_stats_plain)
    nbytes, flops = chunk_bytes_flops(a)
    lib_fn = chunk_sdpa_yardstick(a)
    return {"swan_chunk_stats": timed_rows(
                f"swan_chunk_stats[bf16] {label}",
                lambda: swan_chunk_stats(*sargs, **skw),
                lambda: swan_chunk_stats_plain(*sargs, **skw), lib_fn,
                nbytes, flops, flush),
            "swan_chunk_stats_paged": timed_rows(
                "swan_chunk_stats_paged[bf16] same operands, paged",
                lambda: swan_chunk_stats_paged(*pargs, **pkw),
                lambda: swan_chunk_stats_paged_plain(*pargs, **pkw), lib_fn,
                nbytes + tab.numel() * 4, flops, flush)}


def chunk_phase():
    """B3 and B4 against their plain twins (at the engine's and the bench's
    shapes and the tiling's edges), B4 == B3 bit for bit on the same
    logical rows, then their times at the engine's chunk shape."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(2)
    # kernel and twin both compute in f32 on the same dequantised values, so
    # every value type is held near f32 agreement (CHUNK_TOL)
    # case -> (sp_len, queries, k): the engine chunk, empty and dead lanes and
    # the bench's full prefix, then the tiling's edges: a ragged query tile
    # (400 = 3 x 128 + 16), k = 32 and 128, and k = 1 (rows of 1-2 bytes,
    # staged without cp.async)
    cases = {"sp_len 1000 | 1920": ([1000, 1920], Q_CHUNK, K),
             "sp_len 0 | 1000": ([0, 1000], Q_CHUNK, K),
             "sp_len 1920 | dead lane": ([1920, 0], Q_CHUNK, K),
             "bench, full prefix": ([CS, CS], Q_CHUNK, K),
             "Q=400, ragged query tile": ([1000, 1920], 400, K),
             "k=32": ([1000, 1920], Q_CHUNK, 32),
             "k=128": ([1920, 1000], Q_CHUNK, DH),
             "k=1": ([1000, 1920], Q_CHUNK, 1)}
    flush = flush_buffer()
    max_err, rows = {}, {}
    for kind in ("bf16", "int8", "fp8", "f32"):
        for case, (sp, q_len, k) in cases.items():
            a = chunk_inputs(kind, sp, gen, q_len, k)
            args = chunk_check(kind, case, a, gen, max_err)
            if kind == "bf16" and case == "sp_len 1000 | 1920":
                rows = chunk_timed_rows("P=2 Q=1024 sp_len 1000|1920", a,
                                        *args, flush)
    del flush
    return max_err, rows


# the served archs' other query groups: yi-9b (32/4 heads) and olmo-1b
# (16/16) at d_head 128 and k 64, internvl2-1b (14/2: G = 7, the padded
# plan's one launch of the G = 8 instance) and whisper-small's decoder
# (12/12) at d_head 64 and k 32, jamba-1.5-large-398b's attention layer
# (64/8) and llama3-405b (128/8: G = 16, two launches of the G = 8
# instance, against jamba's one at the same Kv) at d_head 128 and k 64, as
# the dense, vlm, encdec and hybrid phases serve them: (arch, Kv, G,
# d_head, k)
SERVED_GROUPS = (("yi-9b", 4, 8, DH, K), ("olmo-1b", 16, 1, DH, K),
                 ("internvl2-1b", 2, 7, 64, 32),
                 ("whisper-small", 12, 1, 64, 32),
                 ("jamba-1.5-large-398b", 8, 8, DH, K),
                 ("llama3-405b", 8, 16, DH, K))


def served_groups_phase():
    """B1 and B2 (b=128, every value type) and B3 and B4 (a chunk of 256
    tokens, Q = 256·G) at each served arch's query group, d_head and k:
    each against its plain twin (B2 == B1 and B4 == B3 bit for bit), then
    each timed beside its bound at the serve shape (bf16).  Returns the
    worst errors."""
    import torch
    from repro_torch.kernels.swan_decode.swan_decode import (
        SPLIT_ROWS, swan_decode, swan_decode_paged, swan_decode_paged_plain,
        swan_decode_plain)
    gen = torch.Generator(device="cuda").manual_seed(3)
    tol = {"f32": 1e-5, "bf16": 1e-2, "int8": 1e-2, "fp8": 1e-2}
    R = SPLIT_ROWS
    dec_cases = {"per-sequence pos": [PROMPT + NEW_TOKENS - 2, 1000, 3000, S - 7],
                 "sp_len R-1 / R / R+1 / 1": [n + BUF - 1 for n in
                                              (R - 1, R, R + 1, 1)]}
    chunk_cases = {"sp_len 1000 | 1920": [1000, 1920],
                   "sp_len 1920 | dead lane": [1920, 0]}
    names = ("k_vals", "k_idx", "v_vals", "v_idx", "k_scale", "v_scale")
    flush = flush_buffer()
    max_err = {}
    for arch, kv, g, dh, k in SERVED_GROUPS:
        shape = f"{arch} Kv={kv} G={g} dh={dh} k={k}"
        for kind in ("bf16", "int8", "fp8", "f32"):
            for case, pos in dec_cases.items():
                decode_check(kind, f"{arch} Kv={kv} {case}",
                             decode_inputs(kind, pos, gen, k, g, dh, kv),
                             tol[kind], max_err)
        a = decode_inputs("bf16", [PROMPT + NEW_TOKENS - 2] * B, gen, k, g,
                          dh, kv)
        nbytes, flops = decode_bytes_flops(a)
        lib_fn, _ = sdpa_yardstick(a)
        label = (f"swan_decode[bf16] {shape} serve shape (sp_len "
                 f"{int(a['sp_len'][0])})")
        timed_rows(label, lambda: call(swan_decode, a),
                   lambda: call(swan_decode_plain, a), lib_fn, nbytes, flops,
                   flush)
        log_host_device(label, lambda: call(swan_decode, a), a, flush, S)
        sp = [int(x) for x in a["sp_len"].tolist()]
        pool, tab = page_out(a, sp, gen, [n for n in names if n in a], B)
        pargs = ([a["q"], pool["k_vals"], pool["k_idx"], pool["v_vals"],
                  pool["v_idx"]] + [a[n] for n in ARGS[5:]] + [tab])
        got = swan_decode_paged(*pargs)
        want = swan_decode_paged_plain(*pargs).float()
        torch.cuda.synchronize()
        err = (got.float() - want).abs()
        log(f"  swan_decode_paged[bf16] {shape} serve shape: max_abs_err "
            f"{err.max().item():.3e} (tol {tol['bf16']:g} abs+rel)")
        check(bool(torch.isfinite(got).all())
              and not bool((err > tol["bf16"] * (1 + want.abs())).any()),
              f"swan_decode_paged[bf16] {shape}: kernel disagrees with plain")
        max_err["bf16"] = max(max_err["bf16"], err.max().item())
        timed_rows(f"swan_decode_paged[bf16] {shape} serve shape",
                   lambda: swan_decode_paged(*pargs),
                   lambda: swan_decode_paged_plain(*pargs), lib_fn,
                   nbytes + tab.numel() * 4, flops, flush)
        cmax = {}
        for kind in ("bf16", "int8", "fp8", "f32"):
            for case, sp in chunk_cases.items():
                a = chunk_inputs(kind, sp, gen, 256 * g, k, kv, dh)
                args = chunk_check(kind, f"{shape} Q=256x{g} {case}", a, gen,
                                   cmax)
                if kind == "bf16" and not case.endswith("lane"):
                    chunk_timed_rows(f"{shape} P=2 Q=256x{g} {case}", a,
                                     *args, flush)
        max_err["chunk_bf16"] = max(max_err.get("chunk_bf16", 0.0),
                                    cmax["bf16"])
    del flush
    return max_err


# B1/B2 at the query groups the CUDA source has no instance of (the padded
# plan of ``swan_decode.g_plan``: 3 -> 4; 5, 6, 7 -> 8; 12 and 16 -> two
# launches of 8), at internvl2-1b's serve shape (Kv 2, d_head 64, k 32)
GROUP_SIZES = (3, 5, 6, 7, 12, 16)


def group_sizes_phase():
    """B1 and B2 at every G of ``GROUP_SIZES``, every value type: each
    against its plain twin, two B1 launches bit for bit, B2 == B1 bit for
    bit through a shuffled page pool; then B1 timed beside its bound and
    SDPA (bf16).  Returns the worst errors and the timed rows by G."""
    import torch
    from repro_torch.kernels.swan_decode.swan_decode import (
        g_plan, swan_decode, swan_decode_plain)
    gen = torch.Generator(device="cuda").manual_seed(4)
    tol = {"f32": 1e-5, "bf16": 1e-2, "int8": 1e-2, "fp8": 1e-2}
    kv, dh, k = 2, 64, 32
    serve_pos = [VLM_PREFIX + PROMPT + NEW_TOKENS - 2] * B
    cases = {"per-sequence pos": [PROMPT + NEW_TOKENS - 2, 1000, 3000, S - 7],
             "internvl2-1b serve": serve_pos}
    flush = flush_buffer()
    max_err, rows = {}, {}
    for g in GROUP_SIZES:
        inst, groups, per = g_plan(g)
        log(f"  G={g}: {groups} launch(es) of the G={inst} instance, "
            f"{per} query heads each")
        for kind in ("bf16", "int8", "fp8", "f32"):
            for case, pos in cases.items():
                decode_check(kind, f"Kv={kv} {case}",
                             decode_inputs(kind, pos, gen, k, g, dh, kv),
                             tol[kind], max_err)
        a = decode_inputs("bf16", serve_pos, gen, k, g, dh, kv)
        nbytes, flops = decode_bytes_flops(a)
        lib_fn, _ = sdpa_yardstick(a)
        label = (f"swan_decode[bf16] G={g} Kv={kv} dh={dh} k={k} "
                 f"internvl2-1b serve shape (sp_len {int(a['sp_len'][0])})")
        rows[g] = timed_rows(label, lambda: call(swan_decode, a),
                             lambda: call(swan_decode_plain, a), lib_fn,
                             nbytes, flops, flush)
        # the padding is host work around the launch: the device time
        # tells the kernels' own
        log_host_device(label, lambda: call(swan_decode, a), a, flush, S)
    del flush
    return max_err, rows


# ---------------------------------------------------------------------------
# phase 3 (cont.): flash_attention (B5), swan_prune (B6)
# ---------------------------------------------------------------------------

# B5 at the bench's prefill shape: 4 sequences of 2048 tokens, 32/8 heads
FB, FS, FH = 4, 2048, 32
F_CASES = ((FS, FS), (384, 512), (512, 384))     # (Sq, Sk); block 128
# (B, Sq, Sk, H, Kv, dh) at the tiling's edges: G = 1, G = 6, dh = 64, dh
# not a multiple of 16 (40) nor of 8 (20); Sq·G is never a multiple of the
# 128 rows of a block
F_EDGES = ((2, 300, 300, 8, 8, DH), (2, 333, 400, 48, 8, DH),
           (2, 520, 520, 32, 8, 64), (1, 200, 260, 16, 4, 40),
           (1, 130, 130, 8, 2, 20))
BF16_RTOL, BF16_ATOL = 2 ** -7, 1e-3              # one bf16 rounding step


def flash_phase():
    """B5 against its plain twin (the TPU kernel's top-left causal mask) at
    Sq == Sk and Sq != Sk and at the tiling's edges (``F_EDGES``), causal
    and full, f32 (2e-5 abs) and bf16 (one rounding step); then its time at
    the bench shape beside one SDPA call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.analysis import roofline as rl
    from repro_torch.kernels.flash_prefill.flash_prefill import (
        flash_attention, flash_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(3)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    max_err = {}
    shapes = [(FB, Sq, Sk, FH, KV, DH) for Sq, Sk in F_CASES] + list(F_EDGES)
    for kind, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for causal in (True, False):
            for i, (B_, Sq, Sk, H_, Kv_, dh) in enumerate(shapes):
                # blocks of 128 as before at the bench's widths; one block
                # for the edges (the blocks are the caller's contract only)
                bq, bk = (128, 128) if i < len(F_CASES) else (Sq, Sk)
                q = rnd(B_, Sq, H_, dh).to(dt)
                k, v = rnd(B_, Sk, Kv_, dh).to(dt), rnd(B_, Sk, Kv_, dh).to(dt)
                got = flash_attention(q, k, v, causal, bq, bk)
                want = flash_attention_plain(q, k, v, causal).float()
                torch.cuda.synchronize()
                err = (got.float() - want).abs()
                ok = (bool((err <= 2e-5).all()) if kind == "f32" else
                      bool((err <= BF16_ATOL + BF16_RTOL * want.abs()).all()))
                what = (f"B={B_} Sq={Sq} Sk={Sk} H={H_} Kv={Kv_} dh={dh}")
                log(f"  flash_attention[{kind:4s}] {'causal' if causal else 'full':6s}"
                    f" {what}: max_abs_err {err.max().item():.3e} "
                    f"({'2e-5 abs' if kind == 'f32' else 'one bf16 step'})")
                check(bool(torch.isfinite(got).all()) and ok,
                      f"flash_attention[{kind}] causal={causal} {what}: "
                      "kernel disagrees with plain")
                max_err[kind] = max(max_err.get(kind, 0.0), err.max().item())

    # timing at the bench shape (bf16, causal, Sq = Sk = 2048)
    q = rnd(FB, FS, FH, DH).bfloat16()
    k, v = rnd(FB, FS, KV, DH).bfloat16(), rnd(FB, FS, KV, DH).bfloat16()
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_err = (lib_fn().transpose(1, 2).float()
               - flash_attention_plain(q, k, v).float()).abs().max().item()
    log(f"  sdpa yardstick vs plain: max_abs_err {lib_err:.3e}")
    nbytes = rl.flash_kernel_bytes(B=FB, H=FH, Kv=KV, Sq=FS, Sk=FS, dh=DH,
                                   dtype_bytes=2)
    flops = rl.flash_kernel_flops(B=FB, H=FH, Sq=FS, Sk=FS, dh=DH)
    flush = flush_buffer()
    row = timed_rows(f"flash_attention[bf16] causal B={FB} Sq=Sk={FS} H={FH} Kv={KV}",
                     lambda: flash_attention(q, k, v),
                     lambda: flash_attention_plain(q, k, v), lib_fn, nbytes,
                     flops, flush, lib_label="sdpa (is_causal, enable_gqa)")
    del flush
    return max_err, row


# B6 at the bench's winnowing shape: 4 x 8 heads x 2048 vectors of 128
PB_, PS_, PK_ = 4, 2048, 64
# B6 at the edges, (B, Kv, S, dh): dh 64 and 80 (columns padded to 128), S
# not a multiple of the kernel's 64-vector tile, one sequence and one kv
# head, dh = 20 (rows not whole 16-byte pieces: staged element by element)
P_EDGES = ((2, 2, 200, 64), (1, 3, 130, 80), (1, 1, 100, DH), (2, 2, 96, 20))


def prune_inputs(dt, gen, cpu_gen, B_=PB_, Kv_=KV, S_=PS_, dh=DH):
    """(x with distinct magnitudes in every vector, a signed permutation P,
    x from a normal, a random orthogonal P); P f32."""
    import torch
    perm = torch.stack([torch.randperm(dh, generator=cpu_gen) for _ in range(Kv_)])
    sign = torch.randint(0, 2, (Kv_, dh), generator=cpu_gen).float() * 2 - 1
    p_perm = torch.zeros(Kv_, dh, dh)
    p_perm.scatter_(2, perm[:, :, None], sign[:, :, None])     # P[j, d, perm[d]]
    a = torch.randn((Kv_, dh, dh), generator=cpu_gen)
    qm, r = torch.linalg.qr(a)
    p_orth = qm * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None]
    mags = torch.rand((B_, Kv_, S_, dh), generator=gen, device="cuda").argsort(-1) + 1
    signs = torch.randint(0, 2, mags.shape, generator=gen, device="cuda") * 2 - 1
    x_distinct = (mags * signs).float() / 32                # exact in bf16
    x_normal = torch.randn((B_, Kv_, S_, dh), generator=gen, device="cuda")
    return (x_distinct.to(dt), p_perm.cuda(), x_normal.to(dt),
            p_orth.contiguous().cuda())


def prune_check(kind, what, inputs, ks, max_err):
    """B6 against its plain twin on one shape, for each k of ``ks``."""
    import torch
    from repro_torch.device import f32_matmul
    from repro_torch.kernels.swan_prune.swan_prune import (swan_prune,
                                                           swan_prune_plain)
    x_d, p_perm, x_n, p_orth = inputs
    dh = x_d.shape[-1]
    with f32_matmul():
        srt = torch.sort(torch.einsum("bjsd,jde->bjse", x_n.float(), p_orth
                                      ).abs(), dim=-1, descending=True).values
    for k in ks:
        got = swan_prune(x_d, p_perm, k)
        want = swan_prune_plain(x_d, p_perm, k)
        torch.cuda.synchronize()
        exact = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        check(exact, f"swan_prune[{kind}] {what} k={k}: signed permutation "
                     "not bit-equal")
        vals, idx = swan_prune(x_n, p_orth, k)
        wv, wi = swan_prune_plain(x_n, p_orth, k)
        torch.cuda.synchronize()
        n = min(k, dh - 1)
        clear = ((srt[..., :n] - srt[..., 1:n + 1]).amin(-1)
                 > 1e-5 * srt[..., 0])
        same = (idx == wi).all(-1)
        err = (vals.float() - wv.float()).abs()[same]
        ok_vals = (bool((err <= 2e-5).all()) if kind == "f32" else bool(
            (err <= 1e-6 + BF16_RTOL * wv.float().abs()[same]).all()))
        log(f"  swan_prune[{kind:4s}] {what} k={k:3d}: signed permutation == "
            f"plain bit for bit: {exact}; random orthogonal P: idx equal on "
            f"{int(same.sum())} of {same.numel()} vectors, {int((~clear).sum())}"
            f" near-tie vectors (gap <= 1e-5 max|x̂|), {int((~same & clear).sum())}"
            f" clear vectors differ; vals max_abs_err {err.max().item():.3e}")
        check(bool((same | ~clear).all()),
              f"swan_prune[{kind}] {what} k={k}: idx differ off near-ties")
        check(ok_vals and bool(torch.isfinite(vals).all()),
              f"swan_prune[{kind}] {what} k={k}: vals disagree with plain")
        max_err[kind] = max(max_err.get(kind, 0.0), err.max().item())


def prune_phase():
    """B6 against its plain twin: bit for bit under a signed-permutation P
    (every x̂ exact in any summation order) with distinct magnitudes; under
    a random orthogonal P, idx equal on every vector whose twin-side gaps
    between consecutive sorted |x̂| (positions 0..k) exceed 1e-5·max|x̂|,
    the others counted, and vals within 2e-5 (f32) or one bf16 rounding
    step where idx agree; at the bench shape and at ``P_EDGES``.  Then its
    time at the bench shape: event, device (profiler) and host per call."""
    import torch
    from repro_torch.analysis import roofline as rl
    from repro_torch.kernels.swan_prune.swan_prune import (KERNEL, smem_bytes,
                                                           swan_prune,
                                                           swan_prune_plain)
    for code, nb in ((0, 4), (1, 2)):
        got = KERNEL.lib().swan_prune_smem_bytes(code)
        check(got == smem_bytes(nb), f"swan_prune: the kernel takes {got} B "
                                     f"of shared memory, precheck budgets "
                                     f"{smem_bytes(nb)} B")
    gen = torch.Generator(device="cuda").manual_seed(4)
    cpu_gen = torch.Generator().manual_seed(4)
    max_err = {}
    for kind, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        inputs = prune_inputs(dt, gen, cpu_gen)
        prune_check(kind, f"B={PB_} Kv={KV} S={PS_} dh={DH}", inputs,
                    (1, PK_, DH), max_err)
        for B_, Kv_, S_, dh in P_EDGES:
            prune_check(kind, f"B={B_} Kv={Kv_} S={S_} dh={dh}",
                        prune_inputs(dt, gen, cpu_gen, B_, Kv_, S_, dh),
                        sorted({1, 7, dh // 2, dh}), max_err)

    # timing at the bench shape (bf16 x, f32 P, k = 64)
    x, p = inputs[2], inputs[3]

    def lib_fn():       # matmul, topk, gather (+ abs and casts)
        xh = torch.matmul(x.float(), p)
        i = xh.abs().topk(PK_, dim=-1).indices
        return torch.gather(xh, -1, i).to(x.dtype), i.to(torch.int8)
    nbytes = rl.swan_prune_kernel_bytes(B=PB_, Kv=KV, S=PS_, dh=DH, k_max=PK_,
                                        x_bytes=2)
    flops = rl.swan_prune_kernel_flops(B=PB_, Kv=KV, S=PS_, dh=DH)
    flush = flush_buffer()
    row = timed_rows(f"swan_prune[bf16] B={PB_} Kv={KV} S={PS_} k={PK_}",
                     lambda: swan_prune(x, p, PK_),
                     lambda: swan_prune_plain(x, p, PK_), lib_fn, nbytes,
                     flops, flush,
                     lib_label="3 library calls (matmul, topk, gather; + abs, casts)")
    host_us, dev_us, _ = host_device_us(lambda: swan_prune(x, p, PK_), flush,
                                        "swan_prune_")
    log(f"  swan_prune[bf16]: host {host_us:.1f} us per wrapper call, device "
        f"{dev_us:.1f} us per call (profiler; "
        f"{100 * row['bound_ms'] * 1e3 / dev_us:.2f}% of bound by device time)")
    del flush
    return max_err, row


# ---------------------------------------------------------------------------
# phase: the kernel microbenchmark at full width
# ---------------------------------------------------------------------------

def bench_phase(kernels):
    """``repro_torch.benchmarks.bench_kernels.run()`` at full llama3-8b
    width on the card: every roofline row finite and positive, every kernel
    launched (counts zeroed just before, read just after)."""
    import math
    import os
    import torch
    os.environ["REPRO_BENCH_OUT"] = str(Path(__file__).resolve().parent
                                        / "build" / "bench_out")
    from repro_torch.benchmarks.bench_kernels import run
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = run()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    rows = rec.extra["roofline"]
    for r in rows:
        log(f"  roofline {r['name']}: {r['us_per_call']:.2f} us, floor "
            f"{r['floor_us']:.2f} us ({r['bound']}), "
            f"{100 * r['achieved_fraction']:.2f}% of floor")
    log(f"  bench: {len(rows)} roofline rows in {time.perf_counter() - t0:.1f} s; "
        f"launches {launches}")
    check(all(math.isfinite(r[f]) and r[f] > 0 for r in rows
              for f in ("us_per_call", "floor_us", "achieved_fraction")),
          "a roofline row is not finite and positive")
    check(all(n > 0 for n in launches.values()),
          f"a kernel did not run on the bench path: {launches}")
    return launches


# ---------------------------------------------------------------------------
# phases 4-5: serving
# ---------------------------------------------------------------------------

BIASES = ("bq", "bk", "bv", "bo", "b_up", "b_down")


def seeded_biases_(cfg, params, seed=0):
    """Fill a config's biases (zeros at init, as in the reference) with
    seeded N(0, 0.02) values, so the bias and absorbed b̂_v paths see
    non-zero values on the card: a transformer's q/k/v biases, or every
    bias of an encoder-decoder's trees (in sorted key order)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if cfg.is_encoder_decoder:
        def walk(tree):
            for key in sorted(tree):
                if isinstance(tree[key], dict):
                    walk(tree[key])
                elif key in BIASES:
                    tree[key].normal_(0.0, 0.02, generator=gen)
        walk(params)
        return
    if not cfg.qkv_bias:
        return
    for name in ("bq", "bk", "bv"):
        params["layers"]["attn"][name].normal_(0.0, 0.02, generator=gen)


def full_model(arch="llama3-8b", cfg=None):
    """A model (llama3-8b unless ``arch`` names another; ``cfg`` in place
    of its published config where given) at full width and depth (bf16)
    from seeded weights (and seeded q/k/v biases), calibrated and absorbed
    where SWAN applies: (cfg, params, projections), shared by the serve and
    engine phases (and the dense, MoE, VLM, hybrid and ssm phases'
    models)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.io import make_batch
    from repro_torch.models.registry import get_model, swan_applicable
    from repro_torch.runtime.serve_loop import calibrate_swan

    cfg = cfg or get_config(arch)
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = api.init_params(cfg, 0, "cuda")
    seeded_biases_(cfg, params)
    projections = None
    if swan_applicable(cfg):
        projections = calibrate_swan(api, cfg, params, make_batch(
            cfg, 4, 64, seed=3, device="cuda"))
        params = api.absorb(params, cfg, projections)
    torch.cuda.synchronize()
    m = cfg.moe
    ffn = (f"d_ff {cfg.d_ff}" if m is None else
           f"{m.n_routed} routed experts (top-{m.top_k}) + {m.n_shared} "
           f"shared of width {m.d_expert}")
    if cfg.mamba is not None:
        ffn += (f", Mamba (d_state {cfg.mamba.d_state}, expand "
                f"{cfg.mamba.expand}) but attention at layer "
                f"{cfg.attn_offset} of every {cfg.attn_period}")
    if cfg.rwkv is not None:
        ffn += f", RWKV-6 time mix ({cfg.rwkv.head_dim}-wide heads), no attention"
    if cfg.n_prefix_tokens:
        ffn += f", {cfg.n_prefix_tokens} patch embeddings"
    if cfg.is_encoder_decoder:
        ffn += (f", {cfg.n_encoder_layers} encoder layers over "
                f"{cfg.encoder_seq} frames, every bias, learned positions")
    log(f"  init + calibrate + absorb: {time.perf_counter() - t0:.1f} s "
        f"({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, {ffn}, vocab "
        f"{cfg.vocab_size}, {cfg.norm}{', tied' if cfg.tie_embeddings else ''}"
        f"{', q/k/v biases' if cfg.qkv_bias else ''}, {cfg.dtype}; "
        f"{cfg.n_params() / 1e9:.3f} B params, "
        f"{cfg.n_active_params() / 1e9:.3f} B active; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB)")
    return cfg, params, projections


def serve_phase(kernels, model):
    import torch
    from repro_torch.configs import SwanConfig
    from repro_torch.launch.io import make_batch
    from repro_torch.runtime.serve_loop import ServeSession

    cfg, params, projections = model
    swan = SwanConfig(k_max=K, buffer=BUF, mode="topk")
    sess = ServeSession(cfg, params, swan=swan, projections=projections,
                        max_seq=S, batch=B, graphs=False, device="cuda")
    prompt = make_batch(cfg, B, PROMPT, seed=11, device="cuda")

    prefill_ms = []
    for _ in range(2):                      # the first call warms the libraries
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = sess.prefill(prompt)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    check(logits.shape == (B, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "prefill logits not finite")

    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sess.generate(prompt, NEW_TOKENS)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}

    steps = NEW_TOKENS - 1
    decode_ms = (gen_s * 1e3 - prefill_ms[-1]) / steps
    check(tuple(out.shape) == (B, NEW_TOKENS), f"tokens shape {tuple(out.shape)}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "token ids out of range")
    check(launches["swan_decode"] == groups(cfg) * cfg.n_layers * steps,
          f"swan_decode launched {launches['swan_decode']} times, expected "
          f"{groups(cfg)} x {cfg.n_layers} x {steps}")
    rep = sess.cache_report()
    log(f"  prefill {B}x{PROMPT}: {prefill_ms[-1]:.1f} ms (cold {prefill_ms[0]:.1f} ms)")
    log(f"  generate {B}x{NEW_TOKENS}: {gen_s * 1e3:.1f} ms -> decode "
        f"{decode_ms:.2f} ms/step, {B * NEW_TOKENS / gen_s:.1f} tok/s "
        f"(prefill included), {B * steps / (gen_s - prefill_ms[-1] / 1e3):.1f} "
        f"tok/s decode only")
    log(f"  cache [{rep['mode']}]: {rep['bytes'] / 1e6:.1f} MB vs dense "
        f"{rep['dense_bytes'] / 1e6:.1f} MB ({rep['saving']:.1%} saving)")
    log(f"  device memory peak during generate: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  launches during generate: {launches} over {steps} decode steps")
    log(f"  seq 0 tokens: {out[0, :16].tolist()} ...")
    profile_decode(sess, out[:, -1], 4)
    del sess, logits
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def trace_steps(step, steps: int, what: str, graphs=None) -> dict:
    """Trace ``steps`` calls of ``step`` with torch.profiler: the ops by
    device time, the card's busy share of the traced wall time and the SWAN
    kernels' share of the device time.  The profiler slows the host, so the
    busy share is a floor.  Returns the per-step aten ops and CUDA API
    calls and the device executions of each kernel over the window
    (``kernels``: name prefix -> count).  Given the ``GraphSet`` that
    ``step`` replays, it also returns ``replays``: each replay's graph key
    beside the device records the profiler tied to its graph launch
    (None when the launches and the replays do not pair up)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    keys = []
    if graphs is not None:
        run = graphs.run

        def logged(family, key, *a, **kw):
            keys.append((family, key))
            return run(family, key, *a, **kw)
        graphs.run = logged
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        if graphs is not None:
            del graphs.run
    ka = prof.key_averages()
    log(ka.table(sort_by="self_device_time_total", row_limit=12))
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    n_ops = sum(e.count for e in ka if e.key.startswith("aten::")) / steps
    n_api = sum(e.count for e in ka if e.device_type == DeviceType.CPU
                and e.key.startswith("cuda")) / steps
    counts = {name: sum(e.count for e in kernels if name in e.key)
              for name in ("swan_decode_kernel", "swan_decode_merge_kernel",
                           "swan_chunk_mma_kernel", "swan_chunk_f32_kernel")}
    stats = {"aten_ops": n_ops, "cuda_api": n_api, "kernels": counts,
             "busy_ms": busy / steps, "wall_ms": wall_ms / steps,
             "replays": None}
    if graphs is not None:
        # a device record carries the correlation id of the API call that
        # launched it: here the replay's cudaGraphLaunch
        events = prof.events()
        launch = sorted((e for e in events if e.device_type == DeviceType.CPU
                         and e.name.startswith("cudaGraphLaunch")),
                        key=lambda e: e.time_range.start)
        records = {}
        for e in events:
            if e.device_type == DeviceType.CUDA:
                records.setdefault(e.id, Counter())[e.name] += 1
        if len(launch) == len(keys) and any(e.id in records for e in launch):
            stats["replays"] = [(k, records.get(e.id, Counter()))
                                for k, e in zip(keys, launch)]
            per = {}
            for k, rec in stats["replays"]:
                per.setdefault(k, []).append(sum(rec.values()))
            log(f"  profile: {len(keys)} replays paired with their device "
                f"records; records per replay of each graph: "
                f"{ {f'{k[0]}{k[1]}': v for k, v in per.items()} }")
        else:
            log(f"  profile: {len(launch)} graph launches traced against "
                f"{len(keys)} replays; no per-replay records")
    if busy == 0:
        log("  profile: the profiler traced no device time")
        return stats
    shares = []
    # every instance of a library's kernels: swan_decode_kernel<...>,
    # swan_chunk_mma_kernel<...> and swan_chunk_f32_kernel
    for name in ("swan_decode_", "swan_chunk_"):
        t = sum(e.self_device_time_total for e in kernels if name in e.key) / 1e3
        if t:
            shares.append(f"{name}* {t / steps:.2f} ms/step "
                          f"({100 * t / busy:.1f}% of device time)")
    log(f"  profile: {steps} {what}, {wall_ms / steps:.1f} ms/step wall "
        f"(traced), card busy {busy / steps:.1f} ms/step "
        f"({100 * busy / wall_ms:.1f}%), {', '.join(shares)}, "
        f"{n_ops:.0f} aten ops/step, {n_api:.0f} CUDA API calls/step; "
        f"kernel executions {counts}")
    return stats


def profile_decode(sess, tok, steps: int) -> None:
    """Trace ``steps`` more greedy decode steps of the lockstep session."""
    import torch
    state = {"tok": tok}

    def step():
        state["tok"] = torch.argmax(sess.decode(state["tok"]).float(), dim=-1)
    trace_steps(step, steps, "decode steps")


# ---------------------------------------------------------------------------
# phase 6: the continuous-batching engine, slab then paged
# ---------------------------------------------------------------------------

ENGINE_LENS = (2048, 640, 1536, 100, 1024, 1900, 300, 777)
ENGINE_K = (64, 32, 48, 64)
ENGINE_NEW = 32
ENGINE_SLOTS, ENGINE_CHUNK, ENGINE_LANES = 4, 256, 2


def engine_requests(cfg, k_max=K):
    """The engine trace: token prompts, per-request k cycling over
    ``ENGINE_K`` scaled to ``k_max``."""
    from repro_torch.launch.io import make_batch
    from repro_torch.runtime.serve_engine import Request
    return [Request(uid=f"req{i}",
                    tokens=make_batch(cfg, 1, n, seed=100 + i,
                                      device="cpu")["tokens"][0].tolist(),
                    max_new_tokens=ENGINE_NEW,
                    k=ENGINE_K[i % len(ENGINE_K)] * k_max // K)
            for i, n in enumerate(ENGINE_LENS)]


def make_engine(model, k_max=K, lanes=ENGINE_LANES, **kw):
    from repro_torch.configs import SwanConfig
    from repro_torch.runtime.serve_engine import ServeEngine
    cfg, params, projections = model
    return ServeEngine(cfg, params, swan=SwanConfig(k_max=k_max, buffer=BUF),
                       projections=projections, max_seq=S,
                       n_slots=ENGINE_SLOTS, prefill_chunk=ENGINE_CHUNK,
                       prefill_slots=lanes, device="cuda", **kw)


def drive(kernels, eng, reqs, label):
    """Serve ``reqs`` on ``eng`` to the end; every step ends synchronised,
    so the per-step wall times add up to the run.  Launch counts are zeroed
    just before and read just after.  Returns the run's tokens by request,
    launches, dispatches (this run's), final ``cache_report()`` and times."""
    import torch
    for r in reqs:
        eng.submit(r)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    d0, n0, step0 = dict(eng.dispatches), len(eng.completions), eng.step_count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ends, kinds, peak_live = [], [], 0
    while not eng.done:
        n_pre = eng.dispatches["chunk"] + eng.dispatches["prefill"]
        n_dec = eng.dispatches["decode"]
        eng.step()
        torch.cuda.synchronize()
        ends.append(time.perf_counter() - t0)
        kinds.append((eng.dispatches["chunk"] + eng.dispatches["prefill"]
                      - n_pre, eng.dispatches["decode"] - n_dec))
        peak_live = max(peak_live, eng.cache_report()["live_bytes"])
    wall = ends[-1]
    launches = {k.name: k.launches for k in kernels}
    peak_mem = torch.cuda.max_memory_allocated()
    comps = {c.uid: c for c in eng.completions[n0:]}
    step_ms = [1e3 * (e - b) for b, e in zip([0.0] + ends[:-1], ends)]
    dec_only = [ms for ms, (c, d) in zip(step_ms, kinds) if d and not c]
    with_chunk = [ms for ms, (c, d) in zip(step_ms, kinds) if c]
    # decode tokens: every generated token after the first of each request
    n_dec_tok = sum(len(c.tokens) - 1 for c in comps.values())
    ttft_steps = statistics.mean(c.first_token_step - step0
                                 for c in comps.values())
    ttft_ms = statistics.mean(1e3 * ends[c.first_token_step - step0]
                              for c in comps.values())
    rep = eng.cache_report()
    d = {n: eng.dispatches[n] - d0[n] for n in d0}
    stats = {"wall_s": wall, "tok_s": n_dec_tok / wall,
             "chunk_ms": (statistics.mean(with_chunk) if with_chunk
                          else float("nan")),
             "decode_ms": (statistics.mean(dec_only) if dec_only
                           else float("nan")),
             "ttft_steps": ttft_steps, "ttft_ms": ttft_ms,
             "steps": eng.step_count - step0, "peak_gib": peak_mem / 2**30}
    log(f"  [{label}] {stats['steps']} engine steps, dispatches {d}, "
        f"launches {launches}")
    log(f"  [{label}] wall {wall:.2f} s; {sum(len(c.tokens) for c in comps.values())} "
        f"tokens; decode {stats['tok_s']:.1f} tok/s over the run; steps "
        f"with a chunk or prefill dispatch {stats['chunk_ms']:.1f} ms mean "
        f"({len(with_chunk)}), decode-only steps {stats['decode_ms']:.1f} ms "
        f"mean ({len(dec_only)}); mean time to first token {ttft_steps:.1f} "
        f"steps, {ttft_ms:.0f} ms")
    log(f"  [{label}] cache_report: reserved {rep['reserved_bytes']} B, live "
        f"{rep['live_bytes']} B at the end (peak live {peak_live} B), "
        f"page table shipped {rep.get('page_table_shipped_bytes', 0)} B; "
        f"device memory peak {peak_mem / 2**30:.2f} GiB")
    check(len(comps) == len(reqs)
          and all(len(comps[r.uid].tokens) == r.max_new_tokens
                  for r in reqs), f"[{label}] not every request completed")
    check(all(0 <= t < eng.cfg.vocab_size for c in comps.values()
              for t in c.tokens), f"[{label}] token ids out of range")
    return {"tokens": {u: c.tokens for u, c in comps.items()},
            "launches": launches, "dispatches": d, "report": rep,
            "stats": stats, "per_step": kinds}


def check_launches(run, layout, cfg, label):
    """Each layout's kernels launched once per layer per chunk dispatch and
    ``groups(cfg)`` times per layer per decode dispatch, the other
    layout's never (the serve auditor's ``launch_check``)."""
    from repro_torch.analysis.lint.audit import launch_check
    c = launch_check(label, run["launches"], run["dispatches"], layout,
                     cfg.n_layers, groups(cfg))
    check(c.status == "pass", f"[{label}] {c.detail}")


def engine_run(kernels, model, label, rows=None, **kw):
    """The trace on a fresh EAGER engine without metrics (the baseline of
    the graphs phase); with ``rows``, every token's logits row kept there
    (``record_logits``) and in the run as ``rows``."""
    from repro_torch.benchmarks.parity import record_logits
    eng = make_engine(model, graphs=False, metrics=False, **kw)
    if rows is not None:
        record_logits(eng, rows)
    cfg = model[0]
    run = drive(kernels, eng, engine_requests(cfg), label)
    run["rows"] = rows
    check_launches(run, label, cfg, label)
    return run, eng


def engine_phase(kernels, model, keep_rows=False):
    """The eager engine on the slab and the paged pool (the paged run
    keeping its logits rows with ``keep_rows``, for the sharded phase).
    Returns the launch counts by path and the two runs (the graphs
    phase's baseline)."""
    import torch
    slab_run, slab = engine_run(kernels, model, "slab")
    slab_reserved = slab.cache_report()["reserved_bytes"]
    del slab
    gc.collect()
    torch.cuda.empty_cache()
    paged_run, paged = engine_run(kernels, model, "paged",
                                  rows={} if keep_rows else None,
                                  paged=True, page_size=PS)
    slab_tokens, paged_tokens = slab_run["tokens"], paged_run["tokens"]
    same = [u for u in slab_tokens if slab_tokens[u] == paged_tokens[u]]
    log(f"  paged tokens == slab tokens for {len(same)} of {len(slab_tokens)} "
        f"requests; req0: {paged_tokens['req0'][:12]} ...")
    check(len(same) == len(slab_tokens), "paged engine tokens != slab engine's")
    live = paged.cache_report()["live_bytes"]
    check(live < slab_reserved,
          f"paged live bytes {live} not below the slab's reserved {slab_reserved}")
    del paged
    gc.collect()
    torch.cuda.empty_cache()

    # trace 4 engine steps with chunks in flight (a fresh slab engine, two
    # steps in: the 2048-token prompt takes 8 chunks)
    cfg = model[0]
    eng = make_engine(model, graphs=False)
    for r in engine_requests(cfg):
        eng.submit(r)
    for _ in range(2):
        eng.step()
    n0 = dict(eng.dispatches)
    trace_steps(eng.step, 4, "engine steps")
    log(f"  traced steps' dispatches: chunk "
        f"{eng.dispatches['chunk'] - n0['chunk']}, decode "
        f"{eng.dispatches['decode'] - n0['decode']}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return ({"engine_slab": slab_run["launches"],
             "engine_paged": paged_run["launches"]},
            {"slab": slab_run, "paged": paged_run})


# ---------------------------------------------------------------------------
# phase 7: CUDA graphs — the lockstep session and the engine, graphed
# ---------------------------------------------------------------------------

WARM_PROMPT = 2048              # warmup(max_prompt_len=...) of the engines
GRAPH_SPEEDUP = 0.6             # graphed lockstep ms/step <= this x eager


def mixed_requests(cfg, seed=7):
    """The engine trace's prompt lengths shuffled, with random k, token
    budgets and temperatures (every third request samples)."""
    import numpy as np
    from repro_torch.launch.io import make_batch
    from repro_torch.runtime.serve_engine import Request
    rng = np.random.RandomState(seed)
    lens = rng.permutation(ENGINE_LENS)
    return [Request(uid=f"mix{i}",
                    tokens=make_batch(cfg, 1, int(n), seed=200 + i,
                                      device="cpu")["tokens"][0].tolist(),
                    max_new_tokens=int(rng.randint(ENGINE_NEW // 4,
                                                   ENGINE_NEW + 1)),
                    k=int(rng.choice(ENGINE_K)),
                    temperature=0.8 if i % 3 == 2 else 0.0, seed=i)
            for i, n in enumerate(lens)]


SWAN_EXECUTIONS = {"decode": ("swan_decode_kernel",),
                   "decode_merge": ("swan_decode_merge_kernel",),
                   "chunk": ("swan_chunk_mma_kernel", "swan_chunk_f32_kernel")}


def lost_records(replays):
    """The records a profile lost, by a second witness: a graph launches
    all of its kernels or none, so a replay that shows fewer device
    records than another replay of the same graph in the window lost
    them.  Returns ({kind: SWAN executions lost}, n replays compared)."""
    full, lost, n = {}, Counter(), 0
    for key, rec in replays:
        if sum(rec.values()) > sum(full.get(key, Counter()).values()):
            full[key] = rec
    for key, rec in replays:
        if sum(1 for k, _ in replays if k == key) < 2:
            continue
        n += 1
        gone = full[key] - rec
        for kind, names in SWAN_EXECUTIONS.items():
            lost[kind] += sum(c for name, c in gone.items()
                              if any(x in name for x in names))
    return dict(lost), n


def check_executions(label, window, attempts=3):
    """The profiler's device executions of the decode kernel (B1 or B2:
    split and merge kernels) and the chunk kernel (B3 or B4) must equal
    those expected in a traced window of graphed steps.  A window that
    counts fewer is held against the per-replay witness
    (``lost_records``) and printed; up to ``attempts`` windows are traced,
    none may count more than expected, and one must count exactly (a
    tolerance for lost profiler records: one archive run on an H100
    counted one B1 split and merge pair short in one window while the
    launch tally and the tokens were right).  ``window()`` runs one traced
    window and returns (``trace_steps``' stats, {"decode": n, "chunk": n})."""
    for i in range(attempts):
        prof, want = window()
        k = prof["kernels"]
        got = {kind: sum(k[n] for n in names)
               for kind, names in SWAN_EXECUTIONS.items()}
        want = {"decode": want["decode"], "decode_merge": want["decode"],
                "chunk": want.get("chunk", 0)}
        check(all(got[n] <= want[n] for n in want),
              f"[{label}] the profiler saw {got} executions, more than the "
              f"expected {want}")
        if got == want:
            log(f"  [{label}] window {i + 1}: the profiler saw the expected "
                f"{want} executions")
            return
        short = {n: want[n] - got[n] for n in want if got[n] != want[n]}
        if prof["replays"] is None:
            verdict = "no per-replay witness"
        else:
            lost, n = lost_records(prof["replays"])
            explained = all(lost.get(n_, 0) == c for n_, c in short.items())
            verdict = (f"{n} replays of graphs replayed more than once "
                       f"compared: their siblings show {lost} SWAN records "
                       f"lost, which "
                       f"{'accounts' if explained else 'does not account'} "
                       "for the shortfall")
        log(f"  [{label}] window {i + 1}: the profiler saw {got} executions, "
            f"expected {want}, short {short}; witness: {verdict}; tracing "
            "another window")
    check(False, f"[{label}] no traced window saw the expected executions")


def aten_ops(fn, *args):
    """The aten ops one call of ``fn`` dispatches (a CUDA graph's replay
    dispatches none of its own)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn(*args)
    return Count.n


def lockstep_graphs(kernels, model, profile=True, summary=None, swan=None,
                    prompt_len=PROMPT, new_tokens=NEW_TOKENS, max_seq=S,
                    label="lockstep", bitwise=False, speedup=GRAPH_SPEEDUP):
    """The lockstep session eager and graphed in one call: the first
    prefill and decode logits, the generated tokens, decode ms/step; with
    ``profile``, a profile of graphed decode steps.  Each session
    generates once before the timed run, so the timed graphed run only
    replays.  ``summary`` (a dict) receives each mode's numbers and the
    graphed session's cache report.  The batch is ``make_batch``'s: a
    VLM's prompt carries its patch embeddings, an encoder-decoder's its
    frames.  ``swan`` defaults to SwanConfig(k_max=64, buffer=128).  With
    ``bitwise`` the graphed logits must equal the eager ones bit for bit
    (else within 5e-2 of their scale).  A graphed decode step must
    dispatch at most 1/20 of the eager step's aten ops (a replay issues
    only its operand copies) and, where ``speedup`` is given, take at most
    ``speedup`` x the eager step's ms (None: the ratio is logged; for a
    step bound by its weight reads, where a replay saves little)."""
    import torch
    from repro_torch.configs import SwanConfig
    from repro_torch.launch.io import make_batch
    from repro_torch.runtime.serve_loop import ServeSession

    cfg, params, projections = model
    if swan is None:
        swan = SwanConfig(k_max=K, buffer=BUF, mode="topk")
    prompt = make_batch(cfg, B, prompt_len, seed=11, device="cuda")
    res = {}
    for mode in ("eager", "graphed"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sess = ServeSession(cfg, params, swan=swan, projections=projections,
                            max_seq=max_seq, batch=B, graphs=mode == "graphed",
                            device="cuda")
        l0 = sess.prefill(prompt)
        l1 = sess.decode(torch.argmax(l0.float(), dim=-1))
        first = (l0.float(), l1.float())
        sess.generate(prompt, 4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.prefill(prompt)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        out = sess.generate(prompt, new_tokens)
        torch.cuda.synchronize()
        gen_ms = (time.perf_counter() - t0) * 1e3
        launches = {k.name: k.launches for k in kernels}
        steps = new_tokens - 1
        res[mode] = {"first": first, "out": out, "launches": launches,
                     "prefill_ms": prefill_ms,
                     "decode_ms": (gen_ms - prefill_ms) / steps,
                     "tok_s": B * new_tokens / (gen_ms / 1e3),
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        log(f"  [{label} {mode}] prefill {B}x{prompt_len} {prefill_ms:.1f} ms; "
            f"generate {B}x{new_tokens} {gen_ms:.1f} ms -> decode "
            f"{res[mode]['decode_ms']:.2f} ms/step, {res[mode]['tok_s']:.1f} "
            f"tok/s (prefill included); device memory peak "
            f"{res[mode]['peak_gib']:.2f} GiB; launches {launches}")
        check(launches["swan_decode"] == groups(cfg) * cfg.n_layers * steps,
              f"[{label} {mode}] swan_decode launched "
              f"{launches['swan_decode']} times, expected {groups(cfg)} x "
              f"{cfg.n_layers} x {steps}")
        # a VLM's decode continues after its patch positions
        want_pos = cfg.n_prefix_tokens + prompt_len + new_tokens - 1
        check(sess.pos == want_pos,
              f"[{label} {mode}] session at {sess.pos}, expected {want_pos}")
        # one more decode step with its aten ops counted: a replay issues
        # a few (the operand copies), an eager step one set per layer
        res[mode]["ops"] = aten_ops(sess.decode, out[:, -1])
        if mode == "graphed":
            g = sess._graphs
            rep = sess.cache_report()
            res[mode]["report"] = rep
            log(f"  [{label} graphed] graphs {dict(g.captures)}, replays "
                f"{dict(g.replays)}, capture {g.capture_s:.2f} s; cache "
                f"[{rep['mode']}] {rep['bytes'] / 1e6:.1f} MB vs dense "
                f"{rep['dense_bytes'] / 1e6:.1f} MB ({rep['saving']:.1%} "
                "saving)")
        if mode == "graphed" and profile:
            state = {"tok": out[:, -1]}

            def step():
                state["tok"] = torch.argmax(sess.decode(state["tok"]).float(),
                                            dim=-1)
            def window():
                prof = trace_steps(step, 4, "graphed decode steps",
                                   graphs=sess._graphs)
                return prof, {"decode": groups(cfg) * cfg.n_layers * 4}
            check_executions("lockstep graphed", window)
        del sess
    e, g = res["eager"], res["graphed"]
    for what, a, b in (("prefill", e["first"][0], g["first"][0]),
                       ("first decode", e["first"][1], g["first"][1])):
        diff = (a - b).abs().max().item()
        scale = max(1.0, a.abs().max().item())
        log(f"  [{label}] {what} logits graphed vs eager: max|diff| {diff} "
            f"({'bit for bit' if diff == 0 else f'tol {5e-2 * scale:.4f}'})")
        check(diff <= (0.0 if bitwise else 5e-2 * scale),
              f"[{label}] graphed {what} logits differ from eager")
    same = bool(torch.equal(e["out"], g["out"]))
    log(f"  [{label}] graphed tokens == eager tokens: {same}; decode "
        f"{g['decode_ms']:.2f} vs {e['decode_ms']:.2f} ms/step "
        f"({g['decode_ms'] / e['decode_ms']:.3f} x); aten ops per decode "
        f"step {g['ops']} vs {e['ops']}")
    check(same, "graphed lockstep tokens differ from eager")
    check(20 * g["ops"] <= e["ops"],
          f"[{label}] a graphed decode step dispatched {g['ops']} aten ops "
          f"against the eager step's {e['ops']}: not a replay")
    if speedup is not None:
        check(g["decode_ms"] <= speedup * e["decode_ms"],
              f"graphed lockstep {g['decode_ms']:.2f} ms/step is not under "
              f"{speedup} x eager {e['decode_ms']:.2f}")
    if summary is not None:
        summary.update(res)
    return g["launches"], e["launches"]


def engine_graphs(kernels, model, eager, keep=False):
    """The engine graphed, slab then paged: warmup(max_prompt_len=2048)
    captures the whole family (census >= expected in every bucket); the
    trace gives the eager runs' tokens, dispatches and cache_report, with
    one launch per layer per dispatch counted through the replays (the paged
    engine with async_fetch); then the slab engine serves a mixed trace
    that captures nothing new; and on each layout a profile of graphed
    engine steps counts B1 and B3 (slab) or B2 and B4 (paged)
    executions.  With ``keep`` each engine keeps its graphs' descriptions
    (``GraphSet.keep_census``) and is returned for the audit phase."""
    import torch
    from repro_torch.analysis.lint.audit import capture_check
    from repro_torch.obs import EventTrace
    cfg = model[0]
    counts, on_off, warmed = {}, {}, {}
    for layout, kw in (("slab", {}), ("paged", dict(paged=True,
                                                    page_size=PS))):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        eng = make_engine(model, graphs=True, trace=EventTrace(), **kw)
        eng._graphs.keep_census = keep
        mem_state = torch.cuda.memory_allocated()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = eng.warmup(max_prompt_len=WARM_PROMPT)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        census, expected = rep["census"], rep["expected"]
        g = eng._graphs
        log(f"  [{layout} graphed] warmup(max_prompt_len={WARM_PROMPT}): "
            f"{warm_s:.1f} s, {rep['captures']} graphs captured "
            f"({g.capture_s:.1f} s capturing), census {census}; expected "
            f"{expected}; graph memory "
            f"{(torch.cuda.memory_allocated() - mem_state) / 2**30:.3f} GiB "
            f"(the state {(mem_state - mem0) / 2**30:.2f} GiB), device "
            f"memory peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        bad = [b for b in ("decode", "prefill", "insert", "insert_paged")
               if census[b] < expected[b]]
        bad += [f"chunk[{b}]" for b, n in expected["chunk"].items()
                if census["chunk"].get(b, 0) < n]
        check(not bad, f"[{layout} graphed] census below expected in {bad}")
        check(compiles(eng.metrics, "warmup") == rep["captures"]
              and compiles(eng.metrics, "serve") == 0,
              f"[{layout} graphed] serve_compile_total "
              f"{eng.metrics.snapshot()['metrics'].get('serve_compile_total')}"
              f" != the warmup's {rep['captures']} captures")
        lazy0 = sum(g.lazy_captures.values())
        # the paged engine fetches its tokens asynchronously
        eng.async_fetch = layout == "paged"
        label = f"{layout} graphed" + (" async_fetch" if eng.async_fetch
                                       else "")
        run = drive(kernels, eng, engine_requests(cfg), label)
        base = eager[layout]
        check_launches(run, layout, cfg, label)
        check(run["tokens"] == base["tokens"],
              f"[{label}] tokens differ from the eager engine's")
        check(run["dispatches"] == base["dispatches"],
              f"[{label}] dispatches {run['dispatches']} != eager "
              f"{base['dispatches']}")
        check(run["report"] == base["report"],
              f"[{label}] cache_report differs from the eager engine's")
        obs_checks(eng, run, label)
        e, r = base["stats"], run["stats"]
        log(f"  [{label}] vs eager: wall {r['wall_s']:.2f} vs "
            f"{e['wall_s']:.2f} s; decode-only steps {r['decode_ms']:.1f} "
            f"vs {e['decode_ms']:.1f} ms; chunk steps {r['chunk_ms']:.1f} "
            f"vs {e['chunk_ms']:.1f} ms; mean TTFT {r['ttft_ms']:.0f} vs "
            f"{e['ttft_ms']:.0f} ms; {r['tok_s']:.1f} vs {e['tok_s']:.1f} "
            f"decode tok/s; device memory peak {r['peak_gib']:.2f} vs "
            f"{e['peak_gib']:.2f} GiB; tokens, dispatches and "
            "cache_report equal")
        counts[f"graphs_engine_{layout}"] = run["launches"]
        on_off[layout] = metrics_on_off(kernels, eng, run, label)
        if layout == "slab":
            census0 = eng.executable_census()
            drive(kernels, eng, mixed_requests(cfg), "slab graphed mixed")
            check(eng.executable_census() == census0,
                  "[slab graphed mixed] the census changed")

        def window():
            eng.run()
            for r in engine_requests(cfg):
                eng.submit(r)
            for _ in range(2):
                eng.step()
            n0 = dict(eng.dispatches)
            prof = trace_steps(eng.step, 4, f"{label} engine steps",
                               graphs=g)
            dc = eng.dispatches["chunk"] - n0["chunk"]
            dd = eng.dispatches["decode"] - n0["decode"]
            log(f"  traced {label} steps' dispatches: chunk {dc}, decode "
                f"{dd}; the eager engine's traced steps: see [engine]")
            check(dc > 0 and dd > 0, f"[{label}] the traced steps "
                  "dispatched no chunk or no decode")
            return prof, {"decode": groups(cfg) * cfg.n_layers * dd,
                          "chunk": cfg.n_layers * dc}
        check_executions(label, window)
        eng.run()
        c = capture_check(f"{layout} graphed", lazy0,
                          sum(g.lazy_captures.values()))
        check(c.status == "pass", f"[{layout} graphed] {c.detail}: "
              f"{dict(g.lazy_captures)}")
        if keep:
            warmed[layout] = eng
        del eng, g
    monolithic_graphs(kernels, model)
    return counts, on_off, warmed


# ---------------------------------------------------------------------------
# phase 7b: the sharded engine, two data shards laid over the one card
# ---------------------------------------------------------------------------

SHARDS = 2                      # data shards of the sharded phase's mesh
CONTROL_REQS, CONTROL_NEW = 4, 4  # the control's trace: the first requests


def against_one_shard(kernels, model, mesh, one, two, label):
    """dp = 2's eager paged run ``two`` against dp = 1's ``one`` (both with
    their logits rows) by ``repro_torch.benchmarks.parity.compare``: at a
    parting token a near-tie within LOGIT_TOL, and every shared token's
    whole logits row within ROW_TOL.  The chunk dispatch's lane count
    differs between them (``[dp, P_local]``: never fewer than dp lanes),
    and a bf16 product's rounding may follow its shape.  Two more runs
    show what the limit separates: the lane witness, dp = 1 at ``SHARDS *
    ENGINE_LANES`` prefill lanes with every chunk dispatch padded to at
    least SHARDS lanes (dp = 2's schedule and lane counts on one shard),
    which dp = 2 must equal bit for bit, read against dp = 1; and the
    control, dp = 2 with shard 1's lane offset dropped on the first
    CONTROL_REQS requests, which must fail the whole-row limit.  Returns
    the number of requests that parted."""
    import dataclasses
    import torch
    from repro_torch.benchmarks.parity import (ROW_TOL, compare, describe,
                                               pad_chunk_lanes, record_logits)
    from repro_torch.sharding import api
    cfg = model[0]
    main = compare(one["tokens"], one["rows"], two["tokens"], two["rows"],
                   ROW_TOL)
    log(f"  [{label}] dp = {SHARDS} vs dp = 1: {describe(main)}")

    lanes = SHARDS * ENGINE_LANES
    rows_w = {}
    eng = make_engine(model, graphs=False, metrics=False, paged=True,
                      page_size=PS, lanes=lanes)
    pad_chunk_lanes(eng, SHARDS)
    record_logits(eng, rows_w)
    wit = drive(kernels, eng, engine_requests(cfg),
                f"{label} witness: dp = 1, {lanes} lanes, >= {SHARDS} a "
                "chunk dispatch")
    del eng
    self_w = compare(one["tokens"], one["rows"], wit["tokens"], rows_w,
                     ROW_TOL)
    to_two = compare(wit["tokens"], rows_w, two["tokens"], two["rows"], 0.0)
    log(f"  [{label}] witness vs dp = 1: {describe(self_w)}")
    log(f"  [{label}] dp = {SHARDS} vs witness ({two['stats']['steps']} vs "
        f"{wit['stats']['steps']} steps): {describe(to_two)}")

    real = api.ShardLayout.lanes

    def dropped(layout, local):         # shard 1's lane offset dropped
        local = local.long()
        return torch.where(local < layout.n_local, local,
                           torch.full_like(local, layout.n_slots))
    rows_c = {}
    api.ShardLayout.lanes = dropped
    try:
        eng = make_engine(model, graphs=False, metrics=False, mesh=mesh,
                          paged=True, page_size=PS)
        record_logits(eng, rows_c)
        ctl = drive(kernels, eng, [
            dataclasses.replace(r, max_new_tokens=CONTROL_NEW)
            for r in engine_requests(cfg)[:CONTROL_REQS]],
            f"{label} control: shard 1's lane offset dropped")
    finally:
        api.ShardLayout.lanes = real
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    ctrl = compare({u: one["tokens"][u][:CONTROL_NEW] for u in ctl["tokens"]},
                   one["rows"], ctl["tokens"], rows_c, ROW_TOL)
    log(f"  [{label}] control vs dp = 1: {describe(ctrl)}")
    check(main["ok"], f"[{label}] dp = {SHARDS} vs dp = 1: {describe(main)}")
    check(to_two["ok"] and to_two["rows_equal"] == to_two["rows"]
          == sum(map(len, two["tokens"].values())),
          f"[{label}] dp = {SHARDS} != the witness: {describe(to_two)}")
    check(not ctrl["ok_rows"], f"[{label}] the control passed the whole-row "
          f"limit: {describe(ctrl)}")
    return len(main["partings"])


def sharded_phase(kernels, model, eager=None, graphed=None, audit=True):
    """The engine over ``make_serve_mesh(2, devices=["cuda:0"] * 2)``: two
    data shards of 2 slots on the one card, the engine phase's requests,
    slots, chunks and SwanConfig.  64-token pages graphed after
    ``warmup(max_prompt_len=2048)`` (with ``async_fetch``), then a mixed
    trace that must capture nothing; the slab graphed at first use; the
    pages again eagerly.  Checks: paged == slab tokens; graphed == eager
    (tokens, dispatches, cache report); at most one chunk and one decode
    dispatch per step; B2/B4 (paged) and B1/B3 (slab) once per layer per
    dispatch, counted through the replays, not once per shard; per-shard
    reports summing to the totals and equal to the per-shard gauges; the
    pool consistent and drained; dp = 2 against the dp = 1 engine
    (``against_one_shard``); without the audit phase, the serve
    auditor's ``paged-dp2`` row on the warmed engine (with it, the engine
    is returned for that phase).  Returns (launch counts by path, the
    warmed engine or None)."""
    import torch
    from repro_torch.analysis.lint.audit import capture_check, run_audit
    from repro_torch.benchmarks.parity import record_logits
    from repro_torch.configs import SwanConfig
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.obs import EventTrace
    cfg = model[0]
    mesh = make_serve_mesh(SHARDS, ["cuda:0"] * SHARDS)
    counts = {}
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    eng = make_engine(model, graphs=True, mesh=mesh, paged=True,
                      page_size=PS, trace=EventTrace())
    eng._graphs.keep_census = True
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rep = eng.warmup(max_prompt_len=WARM_PROMPT)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t1
    census, expected = rep["census"], rep["expected"]
    g = eng._graphs
    log(f"  [dp{SHARDS} paged graphed] {eng.dp} shards x {eng.n_local} "
        f"slots, {eng.pool.n_pages} pages ({eng.pool.pages_per_shard} a "
        f"shard); warmup(max_prompt_len={WARM_PROMPT}): {warm_s:.1f} s, "
        f"{rep['captures']} graphs captured, census {census}")
    bad = [b for b in ("decode", "prefill", "insert", "insert_paged")
           if census[b] < expected[b]]
    bad += [f"chunk[{b}]" for b, n in expected["chunk"].items()
            if census["chunk"].get(b, 0) < n]
    check(not bad, f"[dp{SHARDS} paged graphed] census below expected in "
          f"{bad}")
    lazy0 = sum(g.lazy_captures.values())
    eng.async_fetch = True
    label = f"dp{SHARDS} paged graphed async_fetch"
    paged = drive(kernels, eng, engine_requests(cfg), label)
    check_launches(paged, "paged", cfg, label)
    check(all(c <= 1 and d <= 1 for c, d in paged["per_step"]),
          f"[{label}] more than one chunk or decode dispatch in a step")
    rep_p = paged["report"]
    sums = {f: sum(sh[f] for sh in rep_p["shards"])
            for f in ("reserved_bytes", "live_bytes",
                      "page_table_shipped_bytes")}
    gauges = [eng.metrics.value("shard_kv_cache_live_bytes", shard=s)
              for s in range(SHARDS)]
    log(f"  [{label}] per-shard reports {rep_p['shards']}; sums {sums}; "
        f"per-shard live-bytes gauges {gauges}")
    check(len(rep_p["shards"]) == SHARDS
          and all(sums[f] == rep_p[f] for f in sums)
          and gauges == [sh["live_bytes"] for sh in rep_p["shards"]],
          f"[{label}] shard entries or gauges do not match the totals")
    eng.pool.check_consistent()
    check(eng.pool.live_pages == 0, f"[{label}] pages leaked")
    obs_checks(eng, paged, label)
    census0 = eng.executable_census()
    drive(kernels, eng, mixed_requests(cfg), f"dp{SHARDS} paged mixed")
    c = capture_check(f"dp{SHARDS} paged graphed", lazy0,
                      sum(g.lazy_captures.values()))
    check(c.status == "pass" and eng.executable_census() == census0,
          f"[dp{SHARDS} paged mixed] {c.detail}: {dict(g.lazy_captures)}")
    counts["sharded_paged_graphed"] = paged["launches"]
    kept = None
    if audit:
        kept = eng
    else:
        for k in kernels:
            k.launches = 0
        checks = run_audit(device="cuda", model=model,
                           swan=SwanConfig(k_max=K, buffer=BUF), max_seq=S,
                           page_size=PS, n_slots=ENGINE_SLOTS,
                           prefill_chunk=ENGINE_CHUNK,
                           prefill_slots=ENGINE_LANES,
                           max_prompt_len=WARM_PROMPT,
                           engines={"paged-dp2": eng},
                           reqs=lambda: mixed_requests(cfg),
                           rows=("paged-dp2",))
        counts["sharded_audit"] = {k.name: k.launches for k in kernels}
        for a in checks:
            print(json.dumps({"audit": a.to_json()}), flush=True)
        by = {a.check: a for a in checks}
        fails = [a.to_json() for a in checks if a.status == "fail"]
        log(f"  [dp{SHARDS} audit] {len(checks)} checks "
            f"{dict(Counter(a.status for a in checks))}: "
            f"{by['engine/paged-dp2'].detail}")
        check(not fails and by["engine/paged-dp2"].status == "pass",
              f"[dp{SHARDS} audit] {fails}")
    del eng, g
    gc.collect()
    torch.cuda.empty_cache()

    eng = make_engine(model, graphs=True, metrics=False, mesh=mesh)
    label = f"dp{SHARDS} slab graphed at first use"
    slab = drive(kernels, eng, engine_requests(cfg), label)
    lazy, n, d = (dict(eng._graphs.lazy_captures), slab["launches"],
                  slab["dispatches"])
    # each capture at first use runs its dispatch once eagerly (dead
    # lanes) before recording it: those launches count too
    check(n["swan_decode"]
          == groups(cfg) * cfg.n_layers * (d["decode"] + lazy.get("decode", 0))
          and n["swan_chunk_stats"]
          == cfg.n_layers * (d["chunk"] + lazy.get("chunk", 0))
          and n["swan_decode_paged"] == n["swan_chunk_stats_paged"] == 0,
          f"[{label}] launches {n} != {cfg.n_layers} x (dispatches {d} + "
          f"captures' warm runs {lazy})")
    check(all(c <= 1 and dd <= 1 for c, dd in slab["per_step"]),
          f"[{label}] more than one chunk or decode dispatch in a step")
    check(slab["tokens"] == paged["tokens"]
          and slab["dispatches"] == paged["dispatches"],
          f"[dp{SHARDS}] slab tokens or dispatches != paged's")
    log(f"  [{label}] graphs captured at first use {lazy}; tokens and "
        f"dispatches == the paged engine's")
    counts["sharded_slab_graphed"] = n
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    eng = make_engine(model, graphs=False, metrics=False, mesh=mesh,
                      paged=True, page_size=PS)
    rows2 = {}
    record_logits(eng, rows2)
    label = f"dp{SHARDS} paged eager"
    ep = drive(kernels, eng, engine_requests(cfg), label)
    ep["rows"] = rows2
    check_launches(ep, "paged", cfg, label)
    check(ep["tokens"] == paged["tokens"]
          and ep["dispatches"] == paged["dispatches"]
          and ep["report"] == paged["report"],
          f"[dp{SHARDS}] graphed paged engine != eager (tokens, dispatches "
          "or cache_report)")
    counts["sharded_paged_eager"] = ep["launches"]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if eager is None:
        eager = {"paged": engine_run(kernels, model, "paged",
                                     rows={}, paged=True, page_size=PS)[0]}
        gc.collect()
        torch.cuda.empty_cache()
    n_part = against_one_shard(kernels, model, mesh, eager["paged"], ep,
                               f"dp{SHARDS} vs dp1")
    p, e1 = paged["stats"], eager["paged"]["stats"]
    g1 = (graphed or {}).get("paged")
    log(f"  [dp{SHARDS}] graphed paged vs dp=1 "
        + (f"graphed paged (the graphs phase, metrics off): decode-only "
           f"steps {p['decode_ms']:.2f} vs {g1['decode_ms']:.2f} ms, chunk "
           f"steps {p['chunk_ms']:.2f} vs {g1['chunk_ms']:.2f} ms, "
           f"{p['steps']} vs {g1['steps']} steps, wall {p['wall_s']:.2f} vs "
           f"{g1['wall_s']:.2f} s, mean TTFT {p['ttft_ms']:.0f} vs "
           f"{g1['ttft_ms']:.0f} ms" if g1 else
           f"(no graphs phase): decode-only {p['decode_ms']:.2f} ms, chunk "
           f"steps {p['chunk_ms']:.2f} ms, {p['steps']} steps")
        + f"; eager paged dp={SHARDS} / dp=1: decode-only "
        f"{ep['stats']['decode_ms']:.1f} / {e1['decode_ms']:.1f} ms, chunk "
        f"steps {ep['stats']['chunk_ms']:.1f} / {e1['chunk_ms']:.1f} ms, "
        f"{ep['stats']['steps']} / {e1['steps']} steps; {n_part} "
        f"request(s) parted from dp=1; phase {time.perf_counter() - t0:.1f} s")
    return counts, kept


# the audit phase's checks that must be present and pass (the rest must
# not fail either)
AUDIT_REQUIRED = tuple(
    f"{what}/{layout}-kernel/{fam}"
    for layout in ("slab", "paged") for fam in ("decode", "chunk")
    for what in ("graph-kernels", "host-transfers", "collectives")) + tuple(
    f"{what}/{layout}-kernel{tail}" for layout in ("slab", "paged")
    for what, tail in (("warmup", "/coverage"), ("warmup", "/idempotent"),
                       ("warmup", "/zero-capture"), ("captures", "/mixed"),
                       ("host-sync", ""), ("exec-count", "/steady-state"))) + (
    "kernel-precheck/swan_decode", "kernel-precheck/swan_decode_paged",
    "kernel-precheck/swan_chunk_stats",
    "kernel-precheck/swan_chunk_stats_paged",
    "kernel-precheck/flash_attention",
    f"logical-view/paged-kernel/decode@pg{S // PS}",
    f"logical-view/paged/decode@pg{S // PS}", "engine/paged-dp2",
    "graph-kernels/paged-dp2-kernel/decode",
    "graph-kernels/paged-dp2-kernel/chunk", "host-sync/paged-dp2-kernel",
    "warmup/paged-dp2-kernel/zero-capture",
    "exec-count/paged-dp2-kernel/steady-state")
ROOFLINE_STEPS = 16             # graphed decode steps timed for the rows


def audit_phase(kernels, model, warmed):
    """The serve auditor (``repro_torch.analysis.lint.audit.run_audit``)
    on the card at llama3-8b's full width: the graphs phase's warmed
    engines (slab and 64-token pages, warmup(max_prompt_len=2048), their
    graph descriptions kept), or engines warmed here when that phase did
    not run; the plain-read engines eager on the card.  Every check is
    printed as JSON; a failed one, or a required one missing or not
    passing, fails the run."""
    from repro_torch.analysis.lint.audit import run_audit
    from repro_torch.configs import SwanConfig
    cfg = model[0]
    t0 = time.perf_counter()
    for k in kernels:
        k.launches = 0
    checks = run_audit(device="cuda", model=model,
                       swan=SwanConfig(k_max=K, buffer=BUF), max_seq=S,
                       page_size=PS, n_slots=ENGINE_SLOTS,
                       prefill_chunk=ENGINE_CHUNK, prefill_slots=ENGINE_LANES,
                       max_prompt_len=WARM_PROMPT, engines=warmed,
                       reqs=lambda: mixed_requests(cfg))
    launches = {k.name: k.launches for k in kernels}
    for c in checks:
        print(json.dumps({"audit": c.to_json()}), flush=True)
    by = {c.check: c for c in checks}
    counts = Counter(c.status for c in checks)
    log(f"  audit: {len(checks)} checks {dict(counts)} in "
        f"{time.perf_counter() - t0:.1f} s (engines "
        f"{'from the graphs phase' if warmed else 'warmed here'})")
    fails = [c.to_json() for c in checks if c.status == "fail"]
    check(not fails, f"audit checks failed: {fails}")
    missing = [n for n in AUDIT_REQUIRED
               if n not in by or by[n].status != "pass"]
    check(not missing, f"audit checks missing or not passing: {missing}")
    return launches


def roofline_rows(kernels, model, smi):
    """Roofline rows of the lockstep cell (llama3-8b, batch 4, a 2048-token
    prompt): its decode step (context 2048) and its 4 x 2048 prefill, each
    counted by the cost analyzer on an eager session (graph replays run no
    aten op; the analyzer sees the kernels' launches) and timed graphed;
    printed through ``report.roofline_table`` with the card's name and
    power limit.  Returns the records."""
    import torch
    from repro_torch.analysis.cost import CostMode
    from repro_torch.analysis.report import measured_share, roofline_table
    from repro_torch.analysis.roofline import roofline_report
    from repro_torch.configs import ShapeConfig, SwanConfig
    from repro_torch.launch.io import make_batch
    from repro_torch.runtime.serve_loop import ServeSession

    cfg, params, projections = model
    swan = SwanConfig(k_max=K, buffer=BUF, mode="topk")
    prompt = make_batch(cfg, B, PROMPT, seed=11, device="cuda")

    def session(graphs):
        return ServeSession(cfg, params, swan=swan, projections=projections,
                            max_seq=S, batch=B, graphs=graphs, device="cuda")
    sess = session(False)
    with CostMode() as m:
        logits = sess.prefill(prompt)
    pre = m.costs
    tok = torch.argmax(logits.float(), dim=-1)
    with CostMode() as m:
        sess.decode(tok)
    dec = m.costs
    del sess, logits
    check(dec.kernel_launches == {"swan_decode": cfg.n_layers},
          f"the analyzed decode step reported {dec.kernel_launches}")
    check(pre.host_transfers == dec.host_transfers == 0,
          "an analyzed step crossed to the host")

    gs = session(True)
    times = {}
    for what, fn in (("prefill", lambda: gs.prefill(prompt)),
                     ("decode", lambda: gs.decode(tok))):
        fn()                            # capture, then time replays
        n = 1 if what == "prefill" else ROOFLINE_STEPS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        torch.cuda.synchronize()
        times[what] = (time.perf_counter() - t0) * 1e3 / n
        if what == "prefill":
            tok = torch.argmax(out.float(), dim=-1)
    del gs
    recs = []
    for what, cost, shape in (
            ("decode", dec, ShapeConfig(f"decode b{B} ctx{PROMPT}", "decode",
                                        PROMPT, B)),
            ("prefill", pre, ShapeConfig(f"prefill {B}x{PROMPT}", "prefill",
                                         PROMPT, B))):
        rec = {"arch": cfg.name, "shape": shape.name, "swan": True,
               "status": "ok", "n_devices": 1, "step_cost": cost.to_json(),
               "measured": {"step_ms": times[what], "device": smi}}
        rec["roofline"] = roofline_report(rec, cfg, shape, swan)
        recs.append(rec)
        kern = sum(o.hbm_bytes for o in cost.ops if o.kind == "kernel")
        top = sorted(cost.by_name().items(),
                     key=lambda kv: -kv[1]["hbm_bytes"])[:4]
        log(f"  [{what}] analyzer: {cost.flops:.6e} flops (matmul "
            f"{cost.flops_of('matmul'):.6e}, kernels "
            f"{cost.flops_of('kernel'):.6e}), {cost.hbm_bytes:.6e} bytes "
            f"(kernels {kern:.6e}), {len(cost.ops)} ops; top bytes "
            f"{[(n, int(r['count']), r['hbm_bytes']) for n, r in top]}; "
            f"model FLOPs {rec['roofline']['model_flops']:.6e}; graphed "
            f"{times[what]:.4f} ms -> {measured_share(rec):.4%} of "
            "989 TFLOP/s")
    for line in roofline_table(recs).splitlines():
        log(f"  {line}")
    print(json.dumps({"roofline": [
        {"shape": r["shape"], "model_flops": r["roofline"]["model_flops"],
         "flops": r["step_cost"]["flops"],
         "hbm_bytes": r["step_cost"]["hbm_bytes"],
         "bottleneck": r["roofline"]["bottleneck"],
         "step_ms": r["measured"]["step_ms"],
         "model_flops_share": measured_share(r), "device": smi}
        for r in recs]}), flush=True)
    return recs


def compiles(metrics, phase):
    """``serve_compile_total``'s captures in ``phase``, over its kinds."""
    fam = metrics.snapshot()["metrics"].get("serve_compile_total")
    return sum(ser["value"] for ser in (fam or {"series": []})["series"]
               if ser["labels"]["phase"] == phase)


def obs_checks(eng, run, label):
    """An instrumented engine's metrics after it served the engine trace
    once: no capture mid-serve, the ``kv_cache_*`` gauges equal to
    ``cache_report()``, every token counted and every request's first
    token and retirement traced."""
    m, trace = eng.metrics, eng.trace
    rep = eng.cache_report()
    n_tok = sum(len(t) for t in run["tokens"].values())
    n_req = len(run["tokens"])
    got = {"serve_compiles": compiles(m, "serve"),
           "reserved": m.value("kv_cache_reserved_bytes"),
           "live": m.value("kv_cache_live_bytes"),
           "tokens": m.value("serve_tokens_generated_total"),
           "first_token": len(trace.select("first_token")),
           "retire": len(trace.select("retire"))}
    want = {"serve_compiles": 0, "reserved": rep["reserved_bytes"],
            "live": rep["live_bytes"], "tokens": n_tok,
            "first_token": n_req, "retire": n_req}
    log(f"  [{label}] obs: {got}")
    check(got == want, f"[{label}] metrics/trace {got} != expected {want}")


def set_obs(eng, metrics, trace):
    """Point a live engine (and its page pool) at another registry and
    event sink."""
    eng.metrics, eng.trace = metrics, trace
    if eng.pool is not None:
        eng.pool.bind_obs(metrics, trace)


def metrics_on_off(kernels, eng, first, label):
    """Serve the engine trace on a warmed engine with metrics and trace
    off, on, on, off: the first run's tokens every time.  Returns the
    runs' stats by mode."""
    from repro_torch.obs import NULL_REGISTRY, EventTrace, MetricsRegistry
    cfg = eng.cfg
    keep = (eng.metrics, eng.trace)
    runs = {"on": [], "off": []}
    try:
        for mode in ("off", "on", "on", "off"):
            if mode == "on":
                set_obs(eng, MetricsRegistry(), EventTrace())
            else:
                set_obs(eng, NULL_REGISTRY, None)
            # the prefill round-robin carries over from the last run:
            # restart it, so that every run has the first run's schedule
            eng._prefill_rr = [s * eng.n_local for s in range(eng.dp)]
            r = drive(kernels, eng, engine_requests(cfg),
                      f"{label} metrics {mode}")
            check(r["tokens"] == first["tokens"]
                  and r["dispatches"] == first["dispatches"],
                  f"[{label} metrics {mode}] tokens or dispatches differ")
            runs[mode].append(r["stats"])
    finally:
        set_obs(eng, *keep)
    return runs


MONO_LENS = (100, 300, 640)     # pads 128, 512, 1024


def monolithic_graphs(kernels, model):
    """Monolithic admission (no chunking), graphed without a warmup: each
    prompt bucket's prefill and insert graphs are captured at first use,
    mid-serve, and the tokens, dispatches and cache report equal an eager
    engine's, slab and paged.  (The warm run of a capture launches the
    kernels for real, so launches are not compared here.)"""
    import torch
    from repro_torch.configs import SwanConfig
    from repro_torch.launch.io import make_batch
    from repro_torch.runtime.serve_engine import Request, ServeEngine
    cfg, params, projections = model

    def requests():
        return [Request(uid=f"mono{i}",
                        tokens=make_batch(cfg, 1, n, seed=300 + i,
                                          device="cpu")["tokens"][0].tolist(),
                        max_new_tokens=8, k=ENGINE_K[i % len(ENGINE_K)])
                for i, n in enumerate(MONO_LENS)]
    for layout, kw in (("slab", {}), ("paged", dict(paged=True,
                                                    page_size=PS))):
        out = {}
        for graphs in (False, True):
            gc.collect()
            torch.cuda.empty_cache()
            eng = ServeEngine(cfg, params, swan=SwanConfig(k_max=K, buffer=BUF),
                              projections=projections, max_seq=S,
                              n_slots=ENGINE_SLOTS, graphs=graphs,
                              device="cuda", **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            comps = eng.run(requests())
            torch.cuda.synchronize()
            out[graphs] = ({c.uid: c.tokens for c in comps},
                           dict(eng.dispatches), eng.cache_report(),
                           time.perf_counter() - t0)
            if graphs:
                census = eng.executable_census()
                lazy = dict(eng._graphs.lazy_captures)
            del eng
        ins = "insert_paged" if layout == "paged" else "insert"
        log(f"  [{layout} monolithic] eager {out[False][3]:.2f} s, graphed "
            f"{out[True][3]:.2f} s (captures at first use included); "
            f"dispatches {out[True][1]}; graphs captured mid-serve {lazy}")
        check(out[True][:3] == out[False][:3],
              f"[{layout} monolithic] graphed tokens, dispatches or "
              "cache_report differ from eager")
        check(census["prefill"] == census[ins] == len(MONO_LENS)
              and lazy.get("prefill") == len(MONO_LENS),
              f"[{layout} monolithic] census {census}, lazy captures {lazy}")


# ---------------------------------------------------------------------------
# phase 9: observability through the launcher
# ---------------------------------------------------------------------------

OBS_REQUESTS, OBS_PROMPT, OBS_NEW, OBS_STEPS = 6, 512, 16, 4


def replay_records(path):
    """The SWAN kernel records of a ``torch.profiler`` Chrome trace, by
    kind (``SWAN_EXECUTIONS``): those the card ran inside graph replays
    (the kernel's correlation id is a ``cudaGraphLaunch``'s) and all of
    them (a capture's warm run launches its kernels eagerly)."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    graph_launch = {e["args"]["correlation"] for e in events
                    if e.get("name", "").startswith("cudaGraphLaunch")
                    and "correlation" in e.get("args", {})}
    if not graph_launch:
        cats = Counter(e.get("cat") for e in events)
        names = sorted({e.get("name", "") for e in events
                        if "Graph" in e.get("name", "")})[:8]
        log(f"  [obs launcher] no cudaGraphLaunch with a correlation id in "
            f"the trace: categories {dict(cats)}; graph names {names}")
    replayed, seen = Counter(), Counter()
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for kind, names in SWAN_EXECUTIONS.items():
            if any(n in e.get("name", "") for n in names):
                seen[kind] += 1
                if e.get("args", {}).get("correlation") in graph_launch:
                    replayed[kind] += 1
    return dict(replayed), dict(seen), len(graph_launch)


def launcher_run(kernels, tmp: Path):
    """One launcher run with the obs flags into ``tmp``: checks its
    metrics file, trace and mid-serve captures against the engine it
    returns.  Returns (launch counts, the profile's replayed SWAN records,
    those expected from the window's dispatches)."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.obs import EventTrace, parse_prometheus
    prom, jsonl, prof = tmp / "metrics.prom", tmp / "trace.jsonl", tmp / "prof"
    argv = ["--arch", "llama3-8b", "--swan", "--k", str(K), "--buffer",
            str(BUF), "--max-seq", str(S), "--batch", str(ENGINE_SLOTS),
            "--requests", str(OBS_REQUESTS), "--prompt-len", str(OBS_PROMPT),
            "--tokens", str(OBS_NEW), "--engine", "--paged", "--page-size",
            str(PS), "--prefill-chunk", str(ENGINE_CHUNK), "--prefill-slots",
            str(ENGINE_LANES), "--metrics-out", str(prom), "--trace-out",
            str(jsonl), "--profile-steps", str(OBS_STEPS), "--profile-dir",
            str(prof)]
    for k in kernels:
        k.launches = 0
    eng = serve.main(argv)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    samples = parse_prometheus(prom.read_text())["samples"]
    events = EventTrace.read(str(jsonl))
    lazy = dict(eng._graphs.lazy_captures)
    n_tok = sum(len(c.tokens) for c in eng.completions)
    serve_caps = sum(v for (name, labels), v in samples.items()
                     if name == "serve_compile_total"
                     and ("phase", "serve") in labels)
    got = {"tokens": samples[("serve_tokens_generated_total", ())],
           "first_token": sum(e["event"] == "first_token" for e in events),
           "retire": sum(e["event"] == "retire" for e in events),
           "serve_captures": serve_caps}
    want = {"tokens": n_tok, "first_token": OBS_REQUESTS,
            "retire": len(eng.completions), "serve_captures":
            sum(lazy.values())}
    log(f"  [obs launcher] {got}; dispatches {eng.dispatches}, captured "
        f"mid-serve {lazy}; launches {launches}")
    check(got == want and n_tok == OBS_REQUESTS * OBS_NEW
          and want["serve_captures"] > 0,
          f"[obs launcher] metrics/trace {got} != expected {want}")
    d = eng.dispatches
    check(launches["swan_decode_paged"] == groups(eng.cfg) * eng.cfg.n_layers
          * (d["decode"] + lazy.get("decode", 0))
          and launches["swan_chunk_stats_paged"]
          == eng.cfg.n_layers * (d["chunk"] + lazy.get("chunk", 0)),
          f"[obs launcher] launches {launches} != {eng.cfg.n_layers} x "
          f"(dispatches {d} + captures' warm runs {lazy}), decode x "
          f"{groups(eng.cfg)}")
    # the profiled window: its steps' dispatches, each one graph replay
    (p0,) = [e["step"] for e in events if e["event"] == "profile_start"]
    (p1,) = [e["step"] for e in events if e["event"] == "profile_stop"]
    win = [e["event"] for e in events if p0 <= e["step"] < p1]
    dd, dc = win.count("decode_dispatch"), win.count("chunk_dispatch")
    path = eng._profiler.path
    replayed, seen, n_launch = replay_records(path)
    log(f"  [obs launcher] profile {Path(path).name} "
        f"({Path(path).stat().st_size / 2**20:.1f} MiB): steps {p0}-{p1}, "
        f"{dc} chunk and {dd} decode dispatches, {n_launch} graph launches; "
        f"SWAN records {seen}, of them in replays {replayed}")
    check(dd > 0 and dc > 0 and seen.get("decode", 0) > 0
          and seen.get("chunk", 0) > 0,
          f"[obs launcher] the profile holds no B2 or no B4 record: {seen}")
    n = eng.cfg.n_layers
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches, replayed, {"decode": n * dd, "decode_merge": n * dd,
                                "chunk": n * dc}


def obs_phase(kernels, attempts=3):
    """The launcher with the obs flags, up to ``attempts`` runs: each run's
    profile may count no more replayed SWAN records than 32 x its window's
    dispatches, and one must count exactly (``check_executions``'
    tolerance for records the profiler loses).  Returns the launch counts
    of the last run."""
    import tempfile
    for i in range(attempts):
        with tempfile.TemporaryDirectory() as tmp:
            launches, got, want = launcher_run(kernels, Path(tmp))
        got = {kind: got.get(kind, 0) for kind in want}
        check(all(got[k] <= want[k] for k in want),
              f"[obs launcher] the profile saw {got} replayed records, more "
              f"than the expected {want}")
        if got == want:
            log(f"  [obs launcher] run {i + 1}: the profile saw the expected "
                f"{want} replayed records")
            return launches
        log(f"  [obs launcher] run {i + 1}: the profile saw {got}, expected "
            f"{want}; running the launcher again")
    check(False, "[obs launcher] no profile saw the expected records")


def log_on_off(on_off, smi):
    """The graphs phase's engine trace served with metrics on and off."""
    for layout, runs in on_off.items():
        row = {mode: (statistics.mean(r["decode_ms"] for r in rs),
                      statistics.mean(r["chunk_ms"] for r in rs),
                      [round(r["wall_s"], 3) for r in rs])
               for mode, rs in runs.items()}
        log(f"  [obs {layout} graphed] metrics on vs off ({smi}): "
            f"decode-only steps {row['on'][0]:.2f} vs {row['off'][0]:.2f} "
            f"ms, chunk steps {row['on'][1]:.2f} vs {row['off'][1]:.2f} ms; "
            f"wall s on {row['on'][2]}, off {row['off'][2]}")


# ---------------------------------------------------------------------------
# phase 8: the chunked prefill at full retention against the dense prefill
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the dense phase: the dense family's other models at full width
# ---------------------------------------------------------------------------

DENSE_ARCHS = ("yi-9b", "olmo-1b", "llama3-405b")
# the serving phases take these archs at a cut of their published depth
# (every width kept), so that the whole script stays inside its 1200 s on
# a slow host (one took 1257.5 s with llama3-8b and rwkv6-3b whole): the
# llama3-8b model of the serve, engine, graphs and audit phases, rwkv6-3b
# and the MoE archs at half of it, yi-9b at a quarter; llama3-405b at 2 of
# its 126 layers (10.58 B params, 21.2 GB in bf16: one card's memory, with
# the plain prefill's attention scores)
DEPTH_CUT = {"llama3-8b": 16, "rwkv6-3b": 16, "yi-9b": 12,
             "deepseek-moe-16b": 14, "qwen2-moe-a2.7b": 12, "llama3-405b": 2}
# archs whose 4 x 2048 lockstep decode step is bound by its weight reads
# at their cut (llama3-405b's 2 layers and 4.2 GB head: graphed 0.71 x
# eager on an H100): the graphed/eager ratio is logged, and the replay is
# held by its aten-op count (``lockstep_graphs``)
DEVICE_BOUND = ("llama3-405b",)
# layers of the full-retention checks (exact_phase, chunk_exact_phase):
# 4, but llama3-405b's 2-layer cut (two 4-layer models would take 2 x 34 GB)
EXACT_LAYERS = {"llama3-405b": 2}


def served_model(arch):
    """``full_model`` of ``arch``, cut to ``DEPTH_CUT`` layers where it
    names the arch (logged)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch in DEPTH_CUT:
        log(f"  [{arch}] depth cut {cfg.n_layers} -> {DEPTH_CUT[arch]} "
            "layers (every width kept): the run's time limit and one "
            "card's memory")
        cfg = cfg.replace(n_layers=DEPTH_CUT[arch])
    return full_model(arch, cfg)


def dense_engine(kernels, model, arch, k_max=K):
    """The engine trace eagerly on the slab (B1, B3), then graphed at first
    use on the 64-row paged pool with ``async_fetch`` (B2, B4): equal
    tokens and dispatches; the two reports' dense bytes equal, the paged
    report's slab-layout bytes at most the slab's reserved bytes (which
    add the ring positions) and its live bytes below them; each layout's
    kernels launched once per layer per dispatch (through the replays on
    the paged pool, plus once per layer for each graph's warm run at its
    capture).  ``k_max`` sizes the SwanConfig and scales the requests' k.
    Returns the launch counts of both runs."""
    import torch
    cfg = model[0]
    eng = make_engine(model, k_max, graphs=False, metrics=False)
    label = f"{arch} slab eager"
    slab = drive(kernels, eng, engine_requests(cfg, k_max), label)
    check_launches(slab, "slab", cfg, label)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    eng = make_engine(model, k_max, graphs=True, metrics=False, paged=True,
                      page_size=PS, async_fetch=True)
    label = f"{arch} paged graphed async_fetch"
    paged = drive(kernels, eng, engine_requests(cfg, k_max), label)
    g = eng._graphs
    lazy, launches, d = dict(g.lazy_captures), paged["launches"], \
        paged["dispatches"]
    log(f"  [{label}] graphs captured at first use {lazy} in "
        f"{g.capture_s:.1f} s; replays {dict(g.replays)}")
    # each capture at first use runs its dispatch once eagerly (dead lanes)
    # before recording it: those launches count too
    check(launches["swan_decode_paged"]
          == groups(cfg) * cfg.n_layers * (d["decode"] + lazy.get("decode", 0))
          and launches["swan_chunk_stats_paged"]
          == cfg.n_layers * (d["chunk"] + lazy.get("chunk", 0))
          and launches["swan_decode"] == launches["swan_chunk_stats"] == 0,
          f"[{label}] launches {launches} != {cfg.n_layers} x (dispatches "
          f"{d} + captures' warm runs {lazy}), decode x {groups(cfg)}")
    check(paged["tokens"] == slab["tokens"],
          f"[{arch}] paged graphed engine tokens != slab eager engine's")
    check(paged["dispatches"] == slab["dispatches"],
          f"[{arch}] dispatches {paged['dispatches']} != {slab['dispatches']}")
    rs, rp = slab["report"], paged["report"]
    check(rs["dense_bytes"] == rp["dense_bytes"]
          and rp["slab_bytes"] <= rs["reserved_bytes"]
          and rp["live_bytes"] < rs["reserved_bytes"],
          f"[{arch}] cache reports disagree: slab {rs}, paged {rp}")
    log(f"  [{arch}] paged tokens and dispatches == slab's "
        f"({len(slab['tokens'])} requests); dense {rs['dense_bytes']} B in "
        f"both, slab reserved {rs['reserved_bytes']} B (the paged report's "
        f"slab layout {rp['slab_bytes']} B), paged live {rp['live_bytes']} B "
        "at the end")
    del eng, g
    gc.collect()
    torch.cuda.empty_cache()
    return slab["launches"], paged["launches"]


def dense_phase(kernels):
    """yi-9b (G = 8; a quarter of its depth, ``DEPTH_CUT``), olmo-1b (G = 1,
    non-parametric LayerNorm, tied embeddings; full depth) and llama3-405b
    (G = 16: B1/B2 in two groups of 8, twice per layer per decode step; 2
    of 126 layers) at full width, bf16, seeded weights: calibrate,
    absorb, the lockstep session eager and graphed (logits and tokens
    equal, B1 ``groups(cfg)`` times per layer per step), the engine trace
    eager on the slab and graphed on the paged pool, then 4 layers (2 for
    llama3-405b, ``EXACT_LAYERS``) at full retention against the dense
    cache (decode, and a two-chunk prefill on the slab and the pool).
    Returns the launch counts by path."""
    import torch
    counts = {}
    for arch in DENSE_ARCHS:
        t0 = time.perf_counter()
        log(f"[dense] {arch}: full width, SWAN k={K} b={BUF}")
        model = served_model(arch)
        cfg = model[0]
        log(f"  [{arch}] G = {cfg.q_group}: B1/B2 {groups(cfg)} launch(es) "
            "per layer per decode step")
        t1 = time.perf_counter()
        lock = {}
        graphed, eager = lockstep_graphs(
            kernels, model, profile=False, summary=lock,
            speedup=None if arch in DEVICE_BOUND else GRAPH_SPEEDUP)
        counts[f"dense_{arch}_lockstep_eager"] = eager
        counts[f"dense_{arch}_lockstep_graphed"] = graphed
        t2 = time.perf_counter()
        slab, paged = dense_engine(kernels, model, arch)
        counts[f"dense_{arch}_engine_slab"] = slab
        counts[f"dense_{arch}_engine_paged_graphed"] = paged
        del model
        gc.collect()
        torch.cuda.empty_cache()
        t3 = time.perf_counter()
        n_exact = EXACT_LAYERS.get(arch, 4)
        log(f"[dense] {arch}: {n_exact} layers at full width, k=d_head vs "
            "the dense cache (decode; two-chunk prefill, slab and paged)")
        worst = max(exact_phase(kernels, arch, n_layers=n_exact),
                    chunk_exact_phase(kernels, arch, n_layers=n_exact))
        gc.collect()
        torch.cuda.empty_cache()
        t4 = time.perf_counter()
        log(f"[dense] {arch}: worst relative logit error {worst:.4f}; "
            f"seconds: model {t1 - t0:.1f}, lockstep {t2 - t1:.1f}, engine "
            f"{t3 - t2:.1f}, exact {t4 - t3:.1f}, all {t4 - t0:.1f}")
        log("[dense] " + summary_line(
            arch, cfg, lock, worst, f"all {t4 - t0:.1f}"))
    return counts


MOE_ARCHS = ("deepseek-moe-16b", "qwen2-moe-a2.7b")
EXACT_PROMPT = 512              # exact_phase's and chunk_exact_phase's prompt


def moe_phase(kernels):
    """deepseek-moe-16b and qwen2-moe-a2.7b at full width and half depth
    (``DEPTH_CUT``), bf16,
    seeded weights (qwen's biases seeded non-zero), through the dense
    phase's checks: the lockstep session eager and graphed, the engine
    trace eager on the slab and graphed at first use on the paged pool,
    then 4 layers at full retention against the dense cache, its decode
    batch cut so that the monolithic prefill stays under the MoE FFN's
    no-drop limit (T·K <= 4096: nothing dropped, so the comparison is
    exact but for rounding).  That comparison runs in float32: in bf16
    the discrete routing turns rounding into moved experts
    (``bf16_routing`` reports it).  Returns the launch counts by path."""
    import torch
    from repro_torch.models import moe as moe_mod
    counts = {}
    for arch in MOE_ARCHS:
        t0 = time.perf_counter()
        log(f"[moe] {arch}: full width, SWAN k={K} b={BUF}")
        model = served_model(arch)
        cfg = model[0]
        Kt = cfg.moe.top_k

        def cap(what, T):
            C = moe_mod.capacity(cfg, T, True)
            rule = "no drops" if C == T * Kt else "doubled capacity factor"
            return f"{what} T·K = {T * Kt} -> C = {C} ({rule})"
        chunk = ENGINE_LANES * ENGINE_CHUNK
        log(f"  [{arch}] expert capacity (serving): "
            f"{cap(f'lockstep prefill {B}x{PROMPT}', B * PROMPT)}; "
            f"{cap(f'engine chunk {ENGINE_LANES}x{ENGINE_CHUNK}', chunk)}; "
            f"{cap(f'decode {B}', B)}")
        t1 = time.perf_counter()
        lock = {}
        graphed, eager = lockstep_graphs(kernels, model, profile=False,
                                         summary=lock)
        counts[f"moe_{arch}_lockstep_eager"] = eager
        counts[f"moe_{arch}_lockstep_graphed"] = graphed
        t2 = time.perf_counter()
        slab, paged = dense_engine(kernels, model, arch)
        counts[f"moe_{arch}_engine_slab"] = slab
        counts[f"moe_{arch}_engine_paged_graphed"] = paged
        del model
        gc.collect()
        torch.cuda.empty_cache()
        t3 = time.perf_counter()
        batch = max(b for b in range(1, B + 1)
                    if b * EXACT_PROMPT * Kt <= moe_mod.NO_DROP_MAX_ASSIGNMENTS)
        log(f"[moe] {arch}: 4 layers at full width in float32, k=d_head vs "
            f"the dense cache (decode at batch {batch}: T·K = "
            f"{batch * EXACT_PROMPT * Kt}; two-chunk prefill of "
            f"{EXACT_PROMPT}: T·K = {EXACT_PROMPT * Kt}, slab and paged)")
        worst = max(exact_phase(kernels, arch, batch=batch, dtype="float32"),
                    chunk_exact_phase(kernels, arch, dtype="float32"))
        gc.collect()
        torch.cuda.empty_cache()
        bf16 = bf16_routing(arch, batch)
        gc.collect()
        torch.cuda.empty_cache()
        t4 = time.perf_counter()
        e, g = lock["eager"], lock["graphed"]
        rep = g["report"]
        log(f"[moe] {arch}: {cfg.n_params() / 1e9:.3f} B params "
            f"({cfg.n_active_params() / 1e9:.3f} B active); lockstep decode "
            f"graphed {g['decode_ms']:.2f} / eager {e['decode_ms']:.2f} "
            f"ms/step; prefill {B}x{PROMPT} graphed {g['prefill_ms']:.1f} / "
            f"eager {e['prefill_ms']:.1f} ms; device memory peak graphed "
            f"{g['peak_gib']:.2f} / eager {e['peak_gib']:.2f} GiB; cache "
            f"(Eq. 1) SWAN {rep['bytes'] / 1e6:.1f} MB vs dense "
            f"{rep['dense_bytes'] / 1e6:.1f} MB ({rep['saving']:.1%} "
            f"saving); full retention vs dense: worst relative logit error "
            f"{worst:.2e} (float32), {bf16:.4f} (bf16, reported); seconds: "
            f"model {t1 - t0:.1f}, lockstep {t2 - t1:.1f}, engine "
            f"{t3 - t2:.1f}, exact {t4 - t3:.1f}, all {t4 - t0:.1f}")
    return counts


VLM_ARCH, VLM_K = "internvl2-1b", 32


def summary_line(arch, cfg, lock, worst, secs):
    """One line of a served arch's numbers: parameters, lockstep decode and
    prefill (graphed / eager), device memory, the cache (Eq. 1)."""
    e, g = lock["eager"], lock["graphed"]
    rep = g["report"]
    return (f"{arch}: {cfg.n_params() / 1e9:.3f} B params; lockstep decode "
            f"graphed {g['decode_ms']:.2f} / eager {e['decode_ms']:.2f} "
            f"ms/step; prefill graphed {g['prefill_ms']:.1f} / eager "
            f"{e['prefill_ms']:.1f} ms; device memory peak graphed "
            f"{g['peak_gib']:.2f} / eager {e['peak_gib']:.2f} GiB; "
            f"self-attention cache (Eq. 1) SWAN {rep['bytes'] / 1e6:.1f} MB vs "
            f"dense {rep['dense_bytes'] / 1e6:.1f} MB ({rep['saving']:.1%} "
            f"saving); full retention: worst relative logit error {worst:.2e}; "
            f"seconds: {secs}")


def vlm_phase(kernels):
    """internvl2-1b at full width and depth (24 layers, 14/2 heads: G = 7,
    q/k/v biases seeded N(0, 0.02)), bf16, seeded weights, calibrated on a
    batch with patch embeddings: the lockstep session over 256 patch
    embeddings + a 2048-token prompt, eager and graphed (logits bit for
    bit, tokens equal, B1 once per layer per step at G = 7, the session
    continuing at the prefill's full length); the engine trace (token
    prompts) eagerly on the slab (B1, B3) and graphed at first use on the
    paged pool (B2, B4); 4 layers at full retention against the dense cache
    (decode after a prompt with patch embeddings; two-chunk prefill, slab
    and paged).  Returns the launch counts by path."""
    import torch
    from repro_torch.configs import SwanConfig
    t0 = time.perf_counter()
    log(f"[vlm] {VLM_ARCH}: full width and depth, {VLM_PREFIX} patch "
        f"embeddings + {PROMPT} prompt tokens, SWAN k={VLM_K} b={BUF}")
    model = full_model(VLM_ARCH)
    cfg = model[0]
    t1 = time.perf_counter()
    lock, counts = {}, {}
    graphed, eager = lockstep_graphs(
        kernels, model, profile=False, summary=lock,
        swan=SwanConfig(k_max=VLM_K, buffer=BUF), label=f"{VLM_ARCH} lockstep",
        bitwise=True)
    counts["vlm_lockstep_eager"], counts["vlm_lockstep_graphed"] = eager, graphed
    t2 = time.perf_counter()
    slab, paged = dense_engine(kernels, model, VLM_ARCH, k_max=VLM_K)
    counts["vlm_engine_slab"], counts["vlm_engine_paged_graphed"] = slab, paged
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    log(f"[vlm] {VLM_ARCH}: 4 layers at full width, k=d_head vs the dense "
        f"cache (decode after {VLM_PREFIX} patch embeddings + "
        f"{EXACT_PROMPT} tokens; two-chunk prefill of tokens, slab and paged)")
    worst = max(exact_phase(kernels, VLM_ARCH),
                chunk_exact_phase(kernels, VLM_ARCH))
    gc.collect()
    torch.cuda.empty_cache()
    t4 = time.perf_counter()
    log("[vlm] " + summary_line(
        VLM_ARCH, cfg, lock, worst,
        f"model {t1 - t0:.1f}, lockstep {t2 - t1:.1f}, engine {t3 - t2:.1f}, "
        f"exact {t4 - t3:.1f}, all {t4 - t0:.1f}"))
    return counts


# whisper-small's lockstep cell: 1500 frames, a 384-token prompt and 64 new
# tokens (448 positions: Whisper's published decoder context)
WHISPER_PROMPT, WHISPER_NEW = 384, 64


def cross_cache_bytes(cfg, swan, batch):
    """Bytes of the static cross cache: dense k/v, or packed sides."""
    from repro_torch.core.hybrid_cache import packed_vector_bytes
    per = (packed_vector_bytes(cfg, swan) if swan.compress_cross_attn
           else 2 * cfg.d_head)
    return 2 * cfg.n_layers * batch * cfg.n_kv_heads * cfg.encoder_seq * per


def encdec_phase(kernels):
    """whisper-small at full width and depth (12 + 12 layers, 12/12 heads,
    every bias seeded N(0, 0.02)), bf16, seeded weights: the lockstep
    session (the reference serves it lockstep only) over 1500 frames and a
    384-token prompt, 64 new tokens, eager and graphed, with the static
    cross cache dense and then winnowed (``compress_cross_attn``): logits
    bit for bit, tokens equal, B1 once per decoder layer per step (G = 1).
    Then, in float32 at 4 decoder layers, full retention against the dense
    self-attention cache and the winnowed cross cache against the dense
    one (the reference's own test at full width).  Returns the launch
    counts by path."""
    import torch
    from repro_torch.configs import SwanConfig
    arch = "whisper-small"
    t0 = time.perf_counter()
    log(f"[encdec] {arch}: full width and depth, SWAN k={VLM_K} b={BUF}, "
        f"cross cache dense and winnowed")
    model = full_model(arch)
    cfg = model[0]
    counts, secs = {}, [f"model {time.perf_counter() - t0:.1f}"]
    for compress in (False, True):
        t1 = time.perf_counter()
        swan = SwanConfig(k_max=VLM_K, buffer=BUF, compress_cross_attn=compress)
        tag = "cross winnowed" if compress else "cross dense"
        lock = {}
        graphed, eager = lockstep_graphs(
            kernels, model, profile=False, summary=lock, swan=swan,
            prompt_len=WHISPER_PROMPT, new_tokens=WHISPER_NEW,
            max_seq=WHISPER_PROMPT + WHISPER_NEW,
            label=f"{arch} lockstep, {tag}", bitwise=True)
        key = "encdec_cross_winnowed" if compress else "encdec"
        counts[f"{key}_lockstep_eager"] = eager
        counts[f"{key}_lockstep_graphed"] = graphed
        log(f"  [{arch}, {tag}] cross cache {cross_cache_bytes(cfg, swan, B) / 1e6:.1f} "
            f"MB (dense {cross_cache_bytes(cfg, SwanConfig(), B) / 1e6:.1f} MB)")
        log("[encdec] " + summary_line(
            f"{arch} ({tag})", cfg, lock, 0.0,
            f"lockstep {time.perf_counter() - t1:.1f}"))
        secs.append(f"{tag} {time.perf_counter() - t1:.1f}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    worst = encdec_exact(kernels, arch)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[encdec] {arch}: full retention worst relative logit error "
        f"{worst:.2e} (float32); seconds: {', '.join(secs)}, exact "
        f"{time.perf_counter() - t3:.1f}, all {time.perf_counter() - t0:.1f}")
    return counts


def encdec_exact(kernels, arch):
    """4 decoder layers at full width in float32, k = d_head: a batch of 4
    (1500 frames, 384 tokens) prefilled and decoded 8 steps through the
    dense cache, SWAN, and SWAN with the cross cache winnowed.  SWAN
    against dense within 5e-2 of the logits' scale (as every arch), and the
    winnowed cross cache against the dense one within the reference test's
    2e-4 abs + 1e-3 rel; B1 once per layer per decode step in each SWAN
    session.  Returns the worst relative error."""
    import dataclasses
    import torch
    from repro_torch.launch.io import make_batch
    from repro_torch.runtime.serve_loop import ServeSession

    cfg, _, params, proj, absorbed, full = small_model(arch, "float32")
    kw = dict(max_seq=WHISPER_PROMPT + 16, batch=B, graphs=False,
              device="cuda")
    sessions = {"dense": ServeSession(cfg, params, **kw),
                "swan": ServeSession(cfg, absorbed, swan=full,
                                     projections=proj, **kw),
                "swan, cross winnowed": ServeSession(
                    cfg, absorbed, projections=proj, **kw,
                    swan=dataclasses.replace(full, compress_cross_attn=True))}
    check(isinstance(sessions["swan, cross winnowed"].state["cross"]["k"],
                     dict), "the winnowed cross cache is not packed")
    prompt = make_batch(cfg, B, WHISPER_PROMPT, seed=5, device="cuda")
    kern = {k.name: k for k in kernels}["swan_decode"]
    logits = {n: s.prefill(prompt) for n, s in sessions.items()}
    before, worst = kern.launches, 0.0
    for step in range(9):
        ld = logits["dense"].float()
        scale = max(1.0, ld.abs().max().item())
        err = (logits["swan"].float() - ld).abs().max().item()
        a, b = logits["swan, cross winnowed"].float(), logits["swan"].float()
        cross = (a - b).abs().max().item()
        cross_ok = bool(((a - b).abs() <= 2e-4 + 1e-3 * b.abs()).all())
        log(f"  step {step}: max|swan - dense| {err:.2e} (max|dense| "
            f"{scale:.2f}, tol {5e-2 * scale:.4f}); max|cross winnowed - "
            f"cross dense| {cross:.2e} (2e-4 + 1e-3 rel: {cross_ok})")
        check(err <= 5e-2 * scale, "full-retention SWAN logits differ from dense")
        check(cross_ok, "the winnowed cross cache at full retention differs "
              "from the dense one")
        worst = max(worst, err / scale)
        if step == 8:
            break
        tok = ld.argmax(-1)
        logits = {n: s.decode(tok) for n, s in sessions.items()}
    check(kern.launches - before == 2 * groups(cfg) * cfg.n_layers * 8,
          "the exactness decode did not go through the kernel")
    return worst


def bf16_routing(arch, batch):
    """The exact phase's prefill in bf16, reported and not held to the
    tolerance: the router's top-k is discrete, so rounding that differs
    between the dense and the SWAN attention moves a token's K-th expert,
    and that token's FFN output by its gate.  Logs the share of tokens
    routed differently per layer; returns the worst relative error of the
    last logits."""
    from repro_torch.launch.io import make_batch
    from repro_torch.runtime.serve_loop import ServeSession

    cfg, _, params, proj, absorbed, full = small_model(arch)
    kw = dict(max_seq=1024, batch=batch, graphs=False, device="cuda")
    s_swan = ServeSession(cfg, absorbed, swan=full, projections=proj, **kw)
    s_dense = ServeSession(cfg, params, **kw)
    prompt = make_batch(cfg, batch, EXACT_PROMPT, seed=5, device="cuda")
    with RouteRecorder() as r_dense:
        ld = s_dense.prefill(prompt).float()
    with RouteRecorder() as r_swan:
        ls = s_swan.prefill(prompt).float()
    scale = max(1.0, ld.abs().max().item())
    err = (ls - ld).abs().max().item()
    log(f"  [bf16, reported] prefill {batch}x{EXACT_PROMPT}: max|swan - "
        f"dense| {err:.4f} (max|dense| {scale:.2f}: {err / scale:.4f} "
        f"relative); argmax agrees: "
        f"{bool((ls.argmax(-1) == ld.argmax(-1)).all())}; tokens routed "
        f"differently by layer: {route_flips(r_dense, r_swan)}")
    return err / scale


# ---------------------------------------------------------------------------
# hybrid and ssm phases: jamba-1.5-large-398b (one group of 8 layers, 4 of
# its 16 routed experts) and rwkv6-3b (whole) at full width
# ---------------------------------------------------------------------------

HYBRID_ARCH, SSM_ARCH = "jamba-1.5-large-398b", "rwkv6-3b"
HYBRID_ROUTED = 4           # routed experts kept of 16 (top-2 unchanged)
EXACT_F32_TOL = 1e-3        # f32 full retention vs dense, of the logits' scale


def hybrid_config(routed=HYBRID_ROUTED, top_k=None, dtype=None):
    """jamba-1.5-large-398b at every published width, cut to one group of
    ``attn_period`` layers (attention at 4, MoE at 1, 3, 5, 7) and
    ``routed`` of its 16 routed experts (``top_k`` kept unless given);
    ``dtype`` for params and activations (the config's bf16 by default)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(HYBRID_ARCH)
    moe = dataclasses.replace(cfg.moe, n_routed=routed,
                              top_k=top_k or cfg.moe.top_k)
    cfg = cfg.replace(n_layers=cfg.attn_period, moe=moe)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype, param_dtype=dtype)
    return cfg


def tree_bytes(tree):
    from repro_torch.tree import leaves
    return sum(x.numel() * x.element_size() for x in leaves(tree))


def n_attn_layers(cfg):
    return sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))


def recurrent_lockstep(kernels, model, swan, label):
    """The lockstep session eager and then graphed (batch 4, a 2048-token
    prompt, 64 new tokens): the prefill and first decode logits bit for
    bit, the greedy tokens equal, B1 once per attention layer per decode
    step (none without attention).  The prefill runs once per mode (its
    graph's capture and warm run included when graphed); the decode
    ms/step is timed over the 62 steps after the first.  Returns each
    mode's numbers (and launches) and the session's state bytes."""
    import torch
    from repro_torch.launch.io import make_batch
    from repro_torch.runtime.serve_loop import ServeSession

    cfg, params, projections = model
    n_attn = n_attn_layers(cfg)
    prompt = make_batch(cfg, B, PROMPT, seed=11, device="cuda")
    res = {}
    for mode in ("eager", "graphed"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sess = ServeSession(cfg, params, swan=swan, projections=projections,
                            max_seq=S, batch=B, graphs=mode == "graphed",
                            device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l0 = sess.prefill(prompt)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        tok = torch.argmax(l0.float(), dim=-1)
        l1 = sess.decode(tok)
        first = (l0.float(), l1.float())
        toks = [tok, torch.argmax(l1.float(), dim=-1)]
        tok = toks[-1]
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        steps = NEW_TOKENS - 2
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = torch.argmax(sess.decode(tok).float(), dim=-1)
            toks.append(tok)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / steps
        launches = {k.name: k.launches for k in kernels}
        rep = sess.cache_report()
        state_b = tree_bytes({n: v for n, v in sess.state.items()
                              if n != "attn"})
        res[mode] = {"first": first, "out": torch.stack(toks, 1),
                     "launches": launches, "prefill_ms": prefill_ms,
                     "decode_ms": decode_ms, "report": rep,
                     "state_bytes": state_b,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        log(f"  [{label} {mode}] prefill {B}x{PROMPT} {prefill_ms:.1f} ms"
            f"{' (its graph capture and warm run included)' if mode == 'graphed' else ''}; "
            f"decode {decode_ms:.2f} ms/step over {steps} steps; device "
            f"memory peak {res[mode]['peak_gib']:.2f} GiB; launches {launches}")
        check(launches["swan_decode"] == groups(cfg) * n_attn * steps
              and all(n == 0 for name, n in launches.items()
                      if name != "swan_decode"),
              f"[{label} {mode}] launches {launches}, expected swan_decode "
              f"{groups(cfg)} x {n_attn} x {steps}")
        check(sess.pos == PROMPT + NEW_TOKENS - 1,
              f"[{label} {mode}] session at {sess.pos}")
        check(bool(torch.isfinite(first[0]).all())
              and bool(torch.isfinite(first[1]).all()),
              f"[{label} {mode}] logits not finite")
        if mode == "graphed":
            g = sess._graphs
            log(f"  [{label} graphed] graphs {dict(g.captures)}, replays "
                f"{dict(g.replays)}, capture {g.capture_s:.2f} s")
        del sess
    e, g = res["eager"], res["graphed"]
    for what, a, b in (("prefill", e["first"][0], g["first"][0]),
                       ("first decode", e["first"][1], g["first"][1])):
        diff = (a - b).abs().max().item()
        log(f"  [{label}] {what} logits graphed vs eager: max|diff| {diff}")
        check(diff == 0.0, f"[{label}] graphed {what} logits differ from eager")
    same = bool(torch.equal(e["out"], g["out"]))
    log(f"  [{label}] graphed tokens == eager tokens: {same}; decode "
        f"{g['decode_ms']:.2f} vs {e['decode_ms']:.2f} ms/step "
        f"({g['decode_ms'] / e['decode_ms']:.3f} x); seq 0: "
        f"{e['out'][0, :12].tolist()} ...")
    check(same, f"[{label}] graphed lockstep tokens differ from eager")
    return res


def recurrent_requests(cfg):
    """The engine trace (``ENGINE_LENS``, 32 new tokens each) at the
    config's k: the recurrent families take no per-request k."""
    import dataclasses
    return [dataclasses.replace(r, k=None) for r in engine_requests(cfg)]


def recurrent_engine(kernels, model, swan, label, modes=("eager", "graphed")):
    """The engine trace monolithically on the slab, eagerly and (in
    ``modes``) graphed at first use (one prefill graph per distinct prompt
    length: these families take no bucket's ``true_len``): equal tokens,
    dispatches and ``cache_report()``; B1 once per attention layer per
    decode dispatch (plus the decode graph's warm run).  Returns each
    run's launches by mode."""
    import torch
    from repro_torch.runtime.serve_engine import ServeEngine
    cfg, params, projections = model
    n_attn = n_attn_layers(cfg)
    runs = {}
    for mode in modes:
        eng = ServeEngine(cfg, params, swan=swan, projections=projections,
                          max_seq=S, n_slots=ENGINE_SLOTS,
                          graphs=mode == "graphed", metrics=False,
                          device="cuda")
        run = drive(kernels, eng, recurrent_requests(cfg),
                    f"{label} slab {mode}")
        lazy = dict(eng._graphs.lazy_captures) if mode == "graphed" else {}
        d, launches = run["dispatches"], run["launches"]
        check(d["chunk"] == 0 and d["prefill"] == len(ENGINE_LENS),
              f"[{label} {mode}] dispatches {d}")
        check(launches["swan_decode"]
              == groups(cfg) * n_attn * (d["decode"] + lazy.get("decode", 0))
              and all(n == 0 for name, n in launches.items()
                      if name != "swan_decode"),
              f"[{label} {mode}] launches {launches} != {n_attn} x "
              f"(dispatches {d} + captures' warm runs {lazy})")
        if mode == "graphed":
            g = eng._graphs
            log(f"  [{label} slab graphed] graphs captured at first use "
                f"{lazy} in {g.capture_s:.1f} s; replays {dict(g.replays)}")
        runs[mode] = run
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    e = runs["eager"]
    if "graphed" in runs:
        g = runs["graphed"]
        check(g["tokens"] == e["tokens"] and g["dispatches"] == e["dispatches"]
              and g["report"] == e["report"],
              f"[{label}] graphed engine != eager engine")
        log(f"  [{label}] graphed engine tokens, dispatches and cache_report "
            "== eager's")
    log(f"  [{label}] cache_report {e['report']}")
    return {m: r["launches"] for m, r in runs.items()}


def full_retention(kernels, cfg, dense_params, swan_params, proj, batch,
                   prompt_len, tol, label):
    """Full retention (k = d_head) against the dense cache: ``batch``
    prompts of ``prompt_len`` tokens, then 8 greedy decode steps of the
    dense run's tokens; the logits within ``tol`` of their scale at every
    step when ``tol`` is given (else reported), B1 once per attention
    layer per decode step.  Returns the worst relative error."""
    from repro_torch.configs import SwanConfig
    from repro_torch.launch.io import make_batch
    from repro_torch.runtime.serve_loop import ServeSession

    full = SwanConfig(k_max=cfg.d_head, buffer=BUF, mode="topk")
    kw = dict(max_seq=prompt_len + 16, batch=batch, graphs=False,
              device="cuda")
    s_swan = ServeSession(cfg, swan_params, swan=full, projections=proj, **kw)
    s_dense = ServeSession(cfg, dense_params, **kw)
    prompt = make_batch(cfg, batch, prompt_len, seed=5, device="cuda")
    ld, ls = s_dense.prefill(prompt), s_swan.prefill(prompt)
    kern = {k.name: k for k in kernels}["swan_decode"]
    before, worst = kern.launches, 0.0
    for step in range(9):
        scale = max(1.0, ld.float().abs().max().item())
        err = (ls.float() - ld.float()).abs().max().item()
        agree = (ls.argmax(-1) == ld.argmax(-1)).float().mean().item()
        bound = "reported" if tol is None else f"tol {tol * scale:.2e}"
        log(f"  [{label}] step {step}: max|swan - dense| {err:.3e} (max|dense| "
            f"{scale:.2f}, {bound}); argmax agreement {agree:.2f}")
        if tol is not None:
            check(err <= tol * scale,
                  f"[{label}] full-retention SWAN logits differ from dense")
        worst = max(worst, err / scale)
        if step == 8:
            break
        tok = ld.argmax(-1)
        ld, ls = s_dense.decode(tok), s_swan.decode(tok)
    check(kern.launches - before == groups(cfg) * n_attn_layers(cfg) * 8,
          f"[{label}] the full-retention decode did not go through B1")
    return worst


def held_to(label, pairs, atol, rtol):
    """Each (what, got, want) within ``atol + rtol·|want|``, element by
    element; logs the largest difference.  Returns the largest difference
    relative to each pair's scale."""
    worst = 0.0
    for what, a, b in pairs:
        err = (a - b).abs()
        ok = bool((err <= atol + rtol * b.abs()).all())
        scale = max(1.0, b.abs().max().item())
        log(f"  [{label}] {what}: max|diff| {err.max().item():.3e} (max|want| "
            f"{b.abs().max().item():.3e}; tol {atol:g} + {rtol:g} rel: {ok})")
        check(ok, f"[{label}] {what} differ")
        worst = max(worst, err.max().item() / scale)
    return worst


def hybrid_phase(kernels):
    """jamba-1.5-large-398b at every published width, cut to one group of
    8 layers and 4 of 16 routed experts (16.247 B params, 32.5 GB bf16: a
    full group is 45.24 B, 90.5 GB, over the card's 80 GB), bf16, seeded
    weights, SwanConfig(k_max=64, buffer=128), calibrated and absorbed: the
    lockstep session eager and graphed (B1 on the attention layer), the
    engine trace monolithically on the slab (eager), full retention in
    bf16 at batch 2 (reported); then in float32 with 2 routed experts of
    top-2 (11.41 B params: routing cannot flip) full retention against the
    dense cache within ``EXACT_F32_TOL``, and one Mamba layer's chunked
    prefill (output, state, conv tail) against its token recurrence within
    the reference test's 1e-5.  Returns the launch counts by path."""
    import torch
    from repro_torch.configs import SwanConfig, get_config
    from repro_torch.models import jamba, mamba
    from repro_torch.models.registry import get_model
    from repro_torch.runtime.serve_loop import calibrate_swan
    from repro_torch.launch.io import make_batch

    t0 = time.perf_counter()
    full_cfg, cfg = get_config(HYBRID_ARCH), hybrid_config()
    group = full_cfg.replace(n_layers=full_cfg.attn_period)
    log(f"[hybrid] {HYBRID_ARCH}: every published width; cut to 1 of "
        f"{full_cfg.n_layers // full_cfg.attn_period} groups (8 layers: "
        f"attention at 4, Mamba at 0-3 and 5-7, MoE at 1, 3, 5, 7) and "
        f"{HYBRID_ROUTED} of {full_cfg.moe.n_routed} routed experts "
        f"(top-{cfg.moe.top_k} kept): a full group is "
        f"{group.n_params() / 1e9:.2f} B params, "
        f"{2 * group.n_params() / 1e9:.1f} GB in bf16, over the card's 80 GB; "
        f"the cut {cfg.n_params() / 1e9:.3f} B, "
        f"{2 * cfg.n_params() / 1e9:.1f} GB (the published model "
        f"{full_cfg.n_params() / 1e9:.2f} B)")
    swan = SwanConfig(k_max=K, buffer=BUF)
    model = full_model(HYBRID_ARCH, cfg)
    params = model[1]
    weights_b = tree_bytes(params) - tree_bytes(params["embed"])
    t1 = time.perf_counter()
    counts = {}
    lock = recurrent_lockstep(kernels, model, swan, f"{HYBRID_ARCH} lockstep")
    counts["hybrid_lockstep_eager"] = lock["eager"]["launches"]
    counts["hybrid_lockstep_graphed"] = lock["graphed"]["launches"]
    # the Mamba scan's share of the prefill: one Mamba layer's forward over
    # the lockstep prompt's shape, timed alone (the card synchronised)
    gen = torch.Generator(device="cuda").manual_seed(7)
    xh = (torch.randn((B, PROMPT, cfg.d_model), device="cuda", generator=gen)
          * 0.5).to(torch.bfloat16)
    mp = jamba.group_params(params, 0)["pos0"]["mamba"]
    with torch.no_grad():
        torch.cuda.synchronize()
        tm = time.perf_counter()
        mamba.mamba_forward(mp, cfg, xh, return_state=True)
        torch.cuda.synchronize()
    layer_ms = (time.perf_counter() - tm) * 1e3
    n_mamba = cfg.n_layers - n_attn_layers(cfg)
    share = n_mamba * layer_ms / lock["eager"]["prefill_ms"]
    log(f"  [{HYBRID_ARCH}] one Mamba layer's forward over {B}x{PROMPT}: "
        f"{layer_ms:.1f} ms; x {n_mamba} layers = {share:.1%} of the eager "
        f"prefill")
    del xh, mp
    t2 = time.perf_counter()
    # eager only: each prompt length's prefill graph would cost a warm run
    # and a replay of the Mamba scan (the ssm phase runs the graphed engine)
    counts["hybrid_engine_slab"] = recurrent_engine(
        kernels, model, swan, f"{HYBRID_ARCH} engine", modes=("eager",))["eager"]
    t3 = time.perf_counter()
    bf16 = full_retention(kernels, cfg, params, params, model[2], 2,
                          EXACT_PROMPT, None, f"{HYBRID_ARCH} bf16, k=d_head")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    t4 = time.perf_counter()
    xcfg = hybrid_config(routed=2, top_k=2, dtype="float32")
    log(f"[hybrid] float32, 2 routed experts of top-2 (every token takes "
        f"both: routing cannot flip): {xcfg.n_params() / 1e9:.3f} B params, "
        f"{4 * xcfg.n_params() / 1e9:.1f} GB")
    api = get_model(xcfg)
    xparams = api.init_params(xcfg, 1, "cuda")
    proj = calibrate_swan(api, xcfg, xparams,
                          make_batch(xcfg, 4, 64, seed=3, device="cuda"))
    absorbed = api.absorb(xparams, xcfg, proj)
    worst = full_retention(kernels, xcfg, xparams, absorbed, proj, B,
                           EXACT_PROMPT, EXACT_F32_TOL,
                           f"{HYBRID_ARCH} f32, k=d_head")
    # one Mamba layer: chunked prefill (two chunks and a short third) vs
    # the token recurrence, at the reference's own tolerance
    # (tests/test_mamba_rwkv.py:22)
    mp = jamba.group_params(xparams, 0)["pos0"]["mamba"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((1, 2 * mamba.CHUNK + 37, xcfg.d_model), device="cuda",
                    generator=gen) * 0.5
    with torch.no_grad():
        y, fin = mamba.mamba_forward(mp, xcfg, x, return_state=True)
        st = mamba.init_mamba_state(xcfg, 1, "cuda")
        seq = torch.cat([mamba.mamba_decode_step(mp, xcfg, x[:, t:t + 1], st)
                         for t in range(x.shape[1])], dim=1)
    scan = held_to(f"{HYBRID_ARCH} f32 Mamba layer 0, {x.shape[1]} tokens, "
                   "chunked vs token recurrence",
                   (("outputs", y, seq), ("final h", fin["h"], st["h"]),
                    ("conv tail", fin["conv"], st["conv"])), 1e-5, 0.0)
    del xparams, absorbed, proj, mp, st, y, fin, seq
    gc.collect()
    torch.cuda.empty_cache()
    t5 = time.perf_counter()
    e, g = lock["eager"], lock["graphed"]
    rep = g["report"]
    log(f"[hybrid] {HYBRID_ARCH} (cut): {cfg.n_params() / 1e9:.3f} B params "
        f"(published {full_cfg.n_params() / 1e9:.2f} B); weights read per "
        f"decode step {weights_b / 1e9:.2f} GB (every leaf but the "
        f"embedding: every expert, as the MoE family's decode); lockstep "
        f"decode graphed {g['decode_ms']:.2f} / eager {e['decode_ms']:.2f} "
        f"ms/step; prefill {B}x{PROMPT} eager {e['prefill_ms']:.1f} ms "
        f"(graphed, capture included, {g['prefill_ms']:.1f} ms); device "
        f"memory peak graphed {g['peak_gib']:.2f} / eager "
        f"{e['peak_gib']:.2f} GiB; attention cache (Eq. 1, batch {B}, "
        f"max_seq {S}) SWAN {rep['bytes'] / 1e6:.1f} MB vs dense "
        f"{rep['dense_bytes'] / 1e6:.1f} MB ({rep['saving']:.1%} saving); "
        f"recurrent state {g['state_bytes'] / 1e6:.1f} MB "
        f"({cfg.n_layers - n_attn_layers(cfg)} Mamba layers x "
        f"{g['state_bytes'] / (cfg.n_layers - n_attn_layers(cfg)) / 1e6:.2f} "
        f"MB); full retention worst relative logit error {worst:.2e} "
        f"(float32, tol {EXACT_F32_TOL:g}), {bf16:.4f} (bf16, reported); "
        f"Mamba chunked vs recurrence {scan:.2e} of the scale; the Mamba "
        f"layers {share:.1%} of the prefill; seconds: model "
        f"{t1 - t0:.1f}, lockstep {t2 - t1:.1f}, engine {t3 - t2:.1f}, bf16 "
        f"full retention {t4 - t3:.1f}, float32 {t5 - t4:.1f}, all "
        f"{t5 - t0:.1f}")
    return counts


def ssm_phase(kernels):
    """rwkv6-3b at full width, 16 of its 32 layers (``DEPTH_CUT``; d_model
    2560, 40 heads x 64, d_ff 8960), bf16, seeded weights, no SWAN (no KV
    cache): the
    lockstep session eager and graphed, the engine trace monolithically on
    the slab, eager and graphed; then in float32, prefill then decode
    against the forward's logits at the same positions (the reference's
    tests/test_mamba_rwkv.py:71 tolerance) and one layer's chunked wkv
    against its recurrence (the reference test's 2e-4 + 1e-3 rel).  No
    kernel runs on this path: every launch count must stay 0."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.io import make_batch
    from repro_torch.models import rwkv
    from repro_torch.models import transformer as tfm
    from repro_torch.models.registry import get_model
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    cfg = get_config(SSM_ARCH)
    log(f"[ssm] {SSM_ARCH}: full width and depth, no SWAN (no KV cache)")
    model = served_model(SSM_ARCH)
    leaves_n = sum(x.numel() for x in leaves(model[1]))
    t1 = time.perf_counter()
    lock = recurrent_lockstep(kernels, model, None, f"{SSM_ARCH} lockstep")
    t2 = time.perf_counter()
    recurrent_engine(kernels, model, None, f"{SSM_ARCH} engine")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    xcfg = cfg.replace(dtype="float32", param_dtype="float32")
    api = get_model(xcfg)
    xparams = api.init_params(xcfg, 1, "cuda")
    batch = make_batch(xcfg, 2, EXACT_PROMPT + 8, seed=5, device="cuda")
    toks = batch["tokens"]
    with torch.no_grad():
        full = api.forward(xparams, xcfg, {"tokens": toks}).float()
    st = api.init_serve_state(xcfg, None, 2, EXACT_PROMPT + 16, "cuda")
    lg, _ = api.prefill(xparams, xcfg, {"tokens": toks[:, :EXACT_PROMPT]}, st)
    pairs = [("prefill logits", lg[:, 0], full[:, EXACT_PROMPT - 1])]
    for t in range(EXACT_PROMPT, EXACT_PROMPT + 8):
        lg, _ = api.decode_step(xparams, xcfg, toks[:, t], t, st)
        pairs.append((f"decode logits at {t}", lg, full[:, t]))
    logit_err = held_to(f"{SSM_ARCH} f32 prefill {EXACT_PROMPT} + 8 decode "
                        "steps vs the forward", pairs, 2e-3, 1e-3)
    tm = tfm.layer_params(xparams, 0)["tm"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((2, 2 * rwkv.CHUNK + 37, xcfg.d_model), device="cuda",
                    generator=gen) * 0.5
    with torch.no_grad():
        y, S_fin = rwkv.time_mix_forward(tm, xcfg, x, return_state=True)
        rst = rwkv.init_rwkv_state(xcfg, 2, "cuda")
        seq = torch.cat([rwkv.time_mix_decode(tm, xcfg, x[:, t:t + 1], rst)
                         for t in range(x.shape[1])], dim=1)
    wkv_err = held_to(f"{SSM_ARCH} f32 layer 0 time mix, {x.shape[1]} "
                      "tokens, chunked wkv vs recurrence",
                      (("outputs", y, seq), ("final state", S_fin, rst["S"])),
                      2e-4, 1e-3)
    del xparams, full, st, y, S_fin, rst, seq
    gc.collect()
    torch.cuda.empty_cache()
    t4 = time.perf_counter()
    e, g = lock["eager"], lock["graphed"]
    log(f"[ssm] {SSM_ARCH}: {cfg.n_params() / 1e9:.3f} B params by the "
        f"reference's formula, {leaves_n / 1e9:.3f} B in the leaves (the "
        f"formula leaves out the channel mix's w_r); lockstep decode graphed "
        f"{g['decode_ms']:.2f} / eager {e['decode_ms']:.2f} ms/step; prefill "
        f"{B}x{PROMPT} eager {e['prefill_ms']:.1f} ms (graphed, capture "
        f"included, {g['prefill_ms']:.1f} ms); device memory peak graphed "
        f"{g['peak_gib']:.2f} / eager {e['peak_gib']:.2f} GiB; cache (Eq. 1) "
        f"{g['report']['bytes']} B; recurrent state "
        f"{g['state_bytes'] / 1e6:.1f} MB at batch {B}; float32: logits "
        f"{logit_err:.2e}, wkv {wkv_err:.2e} of the scale; seconds: model "
        f"{t1 - t0:.1f}, lockstep {t2 - t1:.1f}, engine {t3 - t2:.1f}, "
        f"float32 {t4 - t3:.1f}, all {t4 - t0:.1f}")


def small_model(arch="llama3-8b", dtype=None, n_layers=4):
    """The exactness phases' model: ``arch`` at full width, ``n_layers``
    layers, seeded weights (params and activations in ``dtype``, the
    config's bf16 by default), calibrated, with the full-retention
    SwanConfig (k = d_head).  Returns (cfg, api, params, projections,
    absorbed, swan)."""
    from repro_torch.configs import SwanConfig, get_config
    from repro_torch.launch.io import make_batch
    from repro_torch.models.registry import get_model
    from repro_torch.runtime.serve_loop import calibrate_swan

    cfg = get_config(arch).replace(n_layers=n_layers)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype, param_dtype=dtype)
    api = get_model(cfg)
    params = api.init_params(cfg, 1, "cuda")
    seeded_biases_(cfg, params, seed=1)
    proj = calibrate_swan(api, cfg, params,
                          make_batch(cfg, 4, 64, seed=3, device="cuda"))
    absorbed = api.absorb(params, cfg, proj)
    full = SwanConfig(k_max=cfg.d_head, buffer=BUF, mode="topk")
    return cfg, api, params, proj, absorbed, full


def chunk_exact_phase(kernels, arch="llama3-8b", dtype=None, n_layers=4):
    """Full retention (k = d_head) makes winnowing lossless: a 512-token
    prompt prefilled as 2 chunks of 256 (slab, then paged) must give the
    dense monolithic prefill's last logits within the bf16 tolerance
    (``dtype`` and ``n_layers`` as in ``small_model``)."""
    import numpy as np
    import torch
    from repro_torch.launch.io import make_batch
    from repro_torch.runtime.page_pool import PagePool

    cfg, api, params, proj, absorbed, full = small_model(arch, dtype,
                                                         n_layers)
    n, C, max_seq = EXACT_PROMPT, ENGINE_CHUNK, 1024
    # token prompts, as the engine's chunks take them (no patch embeddings)
    prompt = {"tokens": make_batch(cfg, 1, n, seed=5, device="cuda")["tokens"]}
    dense_state = api.init_serve_state(cfg, None, 1, max_seq, "cuda")
    want, _ = api.prefill(params, cfg, prompt, dense_state)
    want = want[:, 0].float()
    scale = max(1.0, want.abs().max().item())
    kern = {k.name: k for k in kernels}
    worst = 0.0
    for layout in ("slab", "paged"):
        name = "swan_chunk_stats" if layout == "slab" else "swan_chunk_stats_paged"
        before = kern[name].launches
        if layout == "slab":
            state = api.init_serve_state(cfg, full, 1, max_seq, "cuda")
            pool = None
        else:
            pool = PagePool(max_seq // PS + 1, max_seq // PS, 1, PS)
            state = api.init_paged_state(cfg, full, 1, max_seq, pool.n_pages,
                                         PS, "cuda")
        for c0 in range(0, n, C):
            kw = {"prefix_len": c0 + C}
            if pool is not None:
                pool.ensure(0, max(c0 + C - BUF, 0))
                width = 1 << max(int(pool.n_mapped[0]) - 1, 0).bit_length()
                kw = {"page_tab": torch.as_tensor(
                    np.ascontiguousarray(pool.table[:, :width]), device="cuda")}
            got, state = api.prefill_chunk(
                absorbed, cfg, {"tokens": prompt["tokens"][:, c0:c0 + C]},
                state, [0], [c0], full, proj, true_len=[C], **kw)
        err = (got.float() - want).abs().max().item()
        agree = bool((got.argmax(-1) == want.argmax(-1)).all())
        log(f"  [{layout}] {n // C} chunks of {C}: max|chunked - dense| {err:.4f} "
            f"(max|dense| {scale:.2f}, tol {5e-2 * scale:.4f}); argmax "
            f"agrees: {agree}; {name} launches "
            f"{kern[name].launches - before}")
        check(err <= 5e-2 * scale, f"[{layout}] chunked logits differ from dense")
        check(kern[name].launches - before == cfg.n_layers * (n // C),
              f"[{layout}] the chunk path did not go through {name}")
        worst = max(worst, err / scale)
    return worst


class RouteRecorder:
    """While active, keeps the expert set each ``models.moe.route`` call
    chose for each token (sorted, on the host): a diagnostic that reads
    values back, for eager runs only."""

    def __enter__(self):
        from repro_torch.models import moe
        self.calls, self._route = [], moe.route

        def route(*args, **kw):
            out = self._route(*args, **kw)
            self.calls.append(out[3].sort(dim=-1).values.cpu())
            return out
        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._route


def route_flips(a, b):
    """Per layer, the share of tokens whose expert set differs between two
    recorded runs of the same prompt."""
    return [float((x != y).any(dim=-1).float().mean()) for x, y in
            zip(a.calls, b.calls)]


def exact_phase(kernels, arch="llama3-8b", batch=B, dtype=None, n_layers=4):
    """Full retention (k = d_head) against the dense cache: ``batch``
    prompts of 512 tokens, then 8 decode steps; the logits agree within
    the bf16 tolerance at every step (``dtype`` and ``n_layers`` as in
    ``small_model``).
    For a MoE model also the share of prefill tokens routed differently
    by the two runs, per layer."""
    from repro_torch.launch.io import make_batch
    from repro_torch.runtime.serve_loop import ServeSession

    cfg, _, params, proj, absorbed, full = small_model(arch, dtype, n_layers)
    s_swan = ServeSession(cfg, absorbed, swan=full, projections=proj,
                          max_seq=1024, batch=batch, graphs=False,
                          device="cuda")
    s_dense = ServeSession(cfg, params, max_seq=1024, batch=batch,
                           graphs=False, device="cuda")
    prompt = make_batch(cfg, batch, EXACT_PROMPT, seed=5, device="cuda")
    with RouteRecorder() as r_dense:
        ld = s_dense.prefill(prompt)
    with RouteRecorder() as r_swan:
        ls = s_swan.prefill(prompt)
    if cfg.moe is not None:
        log(f"  [{cfg.dtype}] prefill tokens routed differently, dense vs "
            f"SWAN, by layer: {route_flips(r_dense, r_swan)}")
    kern = {k.name: k for k in kernels}["swan_decode"]
    before = kern.launches
    worst = 0.0
    for step in range(9):
        scale = max(1.0, ld.float().abs().max().item())
        err = (ls.float() - ld.float()).abs().max().item()
        agree = (ls.argmax(-1) == ld.argmax(-1)).float().mean().item()
        log(f"  step {step}: max|swan - dense| {err:.4f} (max|dense| "
            f"{scale:.2f}, tol {5e-2 * scale:.4f}); argmax agreement {agree:.2f}")
        check(err <= 5e-2 * scale, "full-retention SWAN logits differ from dense")
        worst = max(worst, err / scale)
        if step == 8:
            break
        tok = ld.argmax(-1)
        ld, ls = s_dense.decode(tok), s_swan.decode(tok)
    check(kern.launches - before == groups(cfg) * cfg.n_layers * 8,
          "the exactness decode did not go through the kernel")
    return worst


# ---------------------------------------------------------------------------
# phase 10: train — B1 at the quality benches' shapes, full-width training
# with a resume, the tiny LM trained and scored by the six quality benches
# ---------------------------------------------------------------------------

# the quality benches' decode shapes (the tiny LM: Kv=2, G=2, dh=32, f32;
# eval batch 8, SwanConfig(buffer=8)); slab rows cover Fig. 4's 228 tokens
TB, TKV, TG, TDH, TBUF, TS = 8, 2, 2, 32, 8, 240
TINY_KS = (1, 2, 3, 6, 8, 16, 24, 32)
TINY_CASES = {
    # sp_len 0, 0, 0, 1, 31, 64, 100, 228 (ring part filled, then full)
    "per-sequence pos, sp_len 0..228": [0, 3, 7, 8, 38, 71, 107, 235],
    "the NLL benches' last step (sp_len 152)": [159] * TB,
    "Fig. 4's last step (sp_len 220)": [227] * TB,
}
# full-width training: llama3-8b's widths, 4 of its 32 layers (32 need
# ~96 GB before activations: bf16 params and grads, f32 AdamW moments)
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM = 4, 12, 8, 512, 2
# the split run saves asynchronously at step 6 and trains on to step 9
# while the write runs; a fresh Trainer resumes from step 6
TRAIN_CKPT_STEP, TRAIN_SPLIT_STOP = 6, 9


def tiny_decode_inputs(kind, pos, gen, k):
    """B1's operands as the tiny LM's serve path gives them: f32 queries
    and ring, f32 values or int8 values with f32 per-row scales."""
    import torch
    dev = "cuda"
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    idx = lambda: torch.rand((TB, TKV, TS, TDH), generator=gen, device=dev
                             ).argsort(-1)[..., :k].to(torch.int8)
    a = {"q": rnd(TB, TKV, TG, TDH), "k_idx": idx(), "v_idx": idx(),
         "buf_k": rnd(TB, TKV, TBUF, TDH), "buf_v": rnd(TB, TKV, TBUF, TDH),
         "buf_pos": ring_positions(pos, TBUF),
         "pos": torch.tensor(pos, dtype=torch.int32, device=dev)}
    a["sp_len"] = torch.clamp(a["pos"] + 1 - TBUF, min=0).to(torch.int32)
    for s in "kv":
        if kind == "int8":
            a[f"{s}_vals"] = torch.randint(-127, 128, (TB, TKV, TS, k),
                                           generator=gen, device=dev
                                           ).to(torch.int8)
            a[f"{s}_scale"] = rnd(TB, TKV, TS).abs() * 0.05 + 0.01
        else:
            a[f"{s}_vals"] = rnd(TB, TKV, TS, k)
    return a


def tiny_decode_check(tol=5e-5):
    """B1 against its plain twin at the quality benches' shapes (tolerance
    ``tol`` abs+rel, the f32 contract) and against itself (a second launch:
    identical bits).  Returns the largest error."""
    import torch
    from repro_torch.kernels.swan_decode.swan_decode import (
        swan_decode, swan_decode_plain)
    gen = torch.Generator(device="cuda").manual_seed(19)
    worst = 0.0
    for kind in ("f32", "int8"):
        for k in TINY_KS:
            errs, same = [], True
            for case, pos in TINY_CASES.items():
                a = tiny_decode_inputs(kind, pos, gen, k)
                got, again = call(swan_decode, a), call(swan_decode, a)
                want = call(swan_decode_plain, a)
                torch.cuda.synchronize()
                err = (got - want).abs()
                check(bool(torch.isfinite(got).all())
                      and not bool((err > tol * (1 + want.abs())).any()),
                      f"swan_decode[{kind}] k={k} {case}: kernel disagrees "
                      "with plain")
                check(torch.equal(got, again),
                      f"swan_decode[{kind}] k={k} {case}: two launches differ")
                errs.append(err.max().item())
            worst = max(worst, *errs)
            log(f"  swan_decode[{kind}] B={TB} Kv={TKV} G={TG} dh={TDH} "
                f"b={TBUF} k={k}: max_abs_err "
                + " / ".join(f"{e:.2e}" for e in errs)
                + f" over {len(TINY_CASES)} position sets (tol {tol:g} "
                "abs+rel); 2 launches equal")
    return worst


def train_run(tc, steps=None, step_ms=None, writing=None, save_at=()):
    """One ``Trainer.run`` on the card in its own scope (so that its
    params and moments are freed on return): ({step: loss}, parameter
    count, final step).  Only the checkpoints of the steps in ``save_at``
    are written (the trainer's final save is skipped otherwise).  With ``step_ms`` each step's (time, the
    optimizer's device time) in ms is appended, the card synchronised
    before and after the step.  With ``writing``, whether an async
    checkpoint write was running as each step began is appended."""
    import torch
    from repro_torch.runtime.train_loop import Trainer
    from repro_torch.tree import leaves
    from repro_torch.runtime import train_loop
    tr = Trainer(tc, device="cuda")
    real_save = tr.ckpt.save

    def save(step, *args, **kwargs):
        if step in save_at:
            real_save(step, *args, **kwargs)
    tr.ckpt.save = save
    real_update = train_loop.adamw_update
    if step_ms is not None:
        inner = tr.step_fn
        opt_events = []

        def timed_update(*args):
            # CUDA events around the optimizer: its device time, apart
            # from the forward, backward and accumulation before it
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = real_update(*args)
            ev[1].record()
            opt_events.append(ev)
            return out

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(*args)
            torch.cuda.synchronize()
            a, b = opt_events.pop()
            step_ms.append(((time.perf_counter() - t0) * 1e3,
                            a.elapsed_time(b)))
            return out
        tr.step_fn = timed
        train_loop.adamw_update = timed_update
    if writing is not None:
        unwatched = tr.step_fn

        def watched(*args):
            th = tr.ckpt._thread
            writing.append(th is not None and th.is_alive())
            return unwatched(*args)
        tr.step_fn = watched
    try:
        out = tr.run(steps)
    finally:
        tr.preemption.close()
        train_loop.adamw_update = real_update
    n_params = sum(x.numel() for x in leaves(out["params"]))
    return {r["step"]: r["loss"] for r in out["log"]}, n_params, out["step"]


def train_fullwidth(smi):
    """llama3-8b's widths at 4 layers, bf16, remat, two microbatches:
    12 steps straight; then 9 steps with an async checkpoint at step 6,
    written while steps 6-8 update the params and moments in place, and a
    fresh Trainer resuming from it to step 12.  Checks finite and falling
    losses, the write overlapping updates, and the split and resumed
    losses against the straight run's."""
    import math
    import shutil
    import tempfile
    import torch
    from repro_torch.analysis.roofline import PEAK_FLOPS
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import OptimizerConfig, TrainConfig, get_config

    full = get_config("llama3-8b")
    cfg = full.replace(n_layers=TRAIN_LAYERS, remat=True,
                       grad_accum=TRAIN_ACCUM)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=2, decay_steps=TRAIN_STEPS)
    log(f"  llama3-8b widths (d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}) "
        f"cut to {TRAIN_LAYERS} of {full.n_layers} layers; {cfg.param_dtype} "
        f"params, {opt.state_dtype} AdamW moments, remat "
        f"{cfg.remat_policy}, grad_accum {TRAIN_ACCUM}, global batch "
        f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, synthetic stream, {TRAIN_STEPS} "
        "steps")
    with tempfile.TemporaryDirectory() as tmp:
        free_gb = shutil.disk_usage(tmp).free / 1e9
        log(f"  checkpoints in a temporary directory ({free_gb:.0f} GB free)")
        base = dict(model=cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                    steps=TRAIN_STEPS, log_every=1, keep_checkpoints=1,
                    async_checkpoint=True, optimizer=opt)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        t0 = time.perf_counter()
        straight, n_params, end = train_run(
            TrainConfig(checkpoint_dir=f"{tmp}/a", checkpoint_every=100,
                        **base), step_ms=ms)
        t_straight = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        shutil.rmtree(f"{tmp}/a", ignore_errors=True)
        t0 = time.perf_counter()
        split = TrainConfig(**{**base, "checkpoint_dir": f"{tmp}/b",
                               "checkpoint_every": TRAIN_CKPT_STEP,
                               "keep_checkpoints": 2})
        writing = []
        first, _, mid = train_run(split, steps=TRAIN_SPLIT_STOP,
                                  writing=writing,
                                  save_at=(TRAIN_CKPT_STEP,))
        saved = Checkpointer(f"{tmp}/b").latest_step()
        resumed, _, end2 = train_run(split)
        t_split = time.perf_counter() - t0
    losses = [straight[s] for s in range(TRAIN_STEPS)]
    log("  losses: " + " ".join(f"{x:.4f}" for x in losses))
    check(end == end2 == TRAIN_STEPS and mid == TRAIN_SPLIT_STOP
          and saved == TRAIN_CKPT_STEP,
          f"steps: straight {end}, split {mid} (resumed from {saved}), "
          f"resumed {end2}")
    overlapped = sum(writing[TRAIN_CKPT_STEP:])
    check(overlapped > 0, f"the step-{TRAIN_CKPT_STEP} async write ended "
          "before the next update began: nothing overlapped it")
    check(all(math.isfinite(x) for x in losses), "a training loss is not finite")
    last3 = sum(losses[-3:]) / 3
    check(last3 < losses[0], f"the loss did not fall: first {losses[0]:.4f}, "
          f"mean of the last three {last3:.4f}")
    check(sorted(resumed) == list(range(TRAIN_CKPT_STEP, TRAIN_STEPS))
          and all(first[s] == straight[s] for s in range(TRAIN_SPLIT_STOP)),
          "the split run's steps are not the straight run's")
    rel = max(abs(resumed[s] - straight[s]) / abs(straight[s])
              for s in resumed)
    exact = all(resumed[s] == straight[s] for s in resumed)
    log(f"  the step-{TRAIN_CKPT_STEP} async save was still writing as "
        f"{overlapped} of the {TRAIN_SPLIT_STOP - TRAIN_CKPT_STEP} in-place "
        f"updates of steps {TRAIN_CKPT_STEP}-{TRAIN_SPLIT_STOP - 1} began")
    log(f"  resumed at step {TRAIN_CKPT_STEP} from the async checkpoint: "
        f"losses of steps {TRAIN_CKPT_STEP}-{TRAIN_STEPS - 1} "
        + ("equal the straight run's bit for bit" if exact else
           f"within {rel:.2e} relative of the straight run's (not bit for "
           "bit)"))
    check(rel <= 1e-3, f"resumed losses differ from the straight run's: {rel}")
    steady = statistics.median(t for t, _ in ms[2:])      # steps 3-12
    opt_ms = statistics.median(o for _, o in ms[2:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mfu = 6 * n_params * tokens / (steady / 1e3) / PEAK_FLOPS   # dense bf16
    log(f"  {smi}: median {steady:.1f} ms/step over steps 3-{TRAIN_STEPS} "
        f"(first two {ms[0][0]:.1f}, {ms[1][0]:.1f} ms), of which AdamW "
        f"{opt_ms:.1f} ms on the card (CUDA events; median); "
        f"{tokens / steady * 1e3:.0f} "
        f"tokens/s; peak device memory {peak / 2**30:.2f} GiB; MFU "
        f"{100 * mfu:.2f}% = 6 x N x tokens / step time / "
        f"{PEAK_FLOPS / 1e12:.0f} TFLOP/s with N "
        f"= {n_params} parameters, {tokens} tokens a step; straight run "
        f"{t_straight:.1f} s, split run with one save and a restore "
        f"{t_split:.1f} s")
    return {"ms_per_step": steady, "adamw_ms": opt_ms, "mfu": mfu,
            "peak_bytes": peak}


# (module, name in the logs, buffered: its decode reads go through B1)
QUALITY_BENCHES = (("bench_table1_retention", True),
                   ("bench_table2_kv_split", False),
                   ("bench_table3_projection", False),
                   ("bench_buffer_rescue", True),
                   ("bench_longcontext_error", True),
                   ("bench_adaptive_k", True))


def quality_phase(kernels):
    """The tiny LM trained for the reference's 900 steps on the card (f32,
    TF32 off), calibrated, and scored by the six quality benches' ``run()``
    (their JSON into build/bench_out).  B1's count is zeroed before each
    bench and read after it: it must rise in the buffered benches and stay
    0 in the buffer=0 ones.  Returns the launches per kernel over the six."""
    import importlib
    import math
    import os
    import re
    import tempfile
    import torch
    from repro_torch.benchmarks import common

    os.environ["REPRO_BENCH_OUT"] = str(Path(__file__).resolve().parent
                                        / "build" / "bench_out")
    total = Counter()
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_BENCH_CKPT"] = tmp
        os.environ["REPRO_BENCH_STEPS"] = "900"
        try:
            t0 = time.perf_counter()
            *_, tlog = common.trained_tiny_lm("cuda", with_log=True)
            torch.cuda.synchronize()
            log(f"  tiny LM (4 layers, d_model 128, f32) trained "
                f"{os.environ['REPRO_BENCH_STEPS']} steps and calibrated in "
                f"{time.perf_counter() - t0:.1f} s: loss "
                f"{tlog[0]['loss']:.4f} -> {tlog[-1]['loss']:.4f}")
            rows = {}
            for name, buffered in QUALITY_BENCHES:
                mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
                for k in kernels:
                    k.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rec = mod.run("cuda")
                torch.cuda.synchronize()
                counts = {k.name: k.launches for k in kernels}
                total.update(counts)
                n = counts["swan_decode"]
                log(f"  {name}: {len(rec.rows)} rows in "
                    f"{time.perf_counter() - t0:.1f} s; swan_decode launches "
                    f"{n}")
                check((n > 0) == buffered and sum(counts.values()) == n,
                      f"{name}: launches {counts} (buffered: {buffered})")
                nums = [float(x) for r in rec.rows for x in re.findall(
                    r"(?:nll|err|delta)=([-+]?(?:\d+\.\d+|nan|inf))",
                    r["derived"])]
                check(nums and all(math.isfinite(x) for x in nums),
                      f"{name}: an NLL or logit error is not finite")
                rows[name] = rec.rows
        finally:
            common._trained.cache_clear()
            del os.environ["REPRO_BENCH_CKPT"], os.environ["REPRO_BENCH_STEPS"]
    full = [r for r in rows["bench_table1_retention"]
            if r["derived"].startswith("ratio=1.00_k=")][0]["derived"]
    delta = float(re.search(r"delta=([-+0-9.]+)", full).group(1))
    log(f"  table 1 at full retention (k = d_head): {full} (|delta| <= 1e-3)")
    check(abs(delta) <= 1e-3, "full retention is not lossless against dense")
    check_row = rows["bench_table3_projection"][-1]["derived"]
    log(f"  table 3 readout (the reference's own, not a gate): {check_row}")
    return dict(total)


def train_phase(kernels, smi):
    t_phase = time.perf_counter()
    log(f"[train] swan_decode vs plain at the quality benches' shapes (B={TB} "
        f"Kv={TKV} G={TG} dh={TDH} b={TBUF}, f32 q; f32 and int8 values; k in "
        f"{TINY_KS})")
    worst = tiny_decode_check()
    log(f"  worst {worst:.2e}")
    log("[train] full-width training (llama3-8b widths, 4 layers), with a "
        "checkpoint resume")
    train_fullwidth(smi)
    log("[train] the tiny LM trained on the card and scored by the six "
        "quality benches")
    counts = quality_phase(kernels)
    log(f"[train] phase {time.perf_counter() - t_phase:.1f} s")
    return counts


# the tensor-core instances: each must hold mma instructions in its SASS and
# spill nothing
TENSOR_CORE_INSTANCES = ("flash_prefill_bf16_kernel", "swan_chunk_mma_kernel",
                         "swan_prune_bf16_kernel")
# every instance of these spills nothing either (B1/B2's splits and merge)
NO_SPILL_INSTANCES = TENSOR_CORE_INSTANCES + ("swan_decode_kernel",
                                              "swan_decode_merge_kernel")


def ptxas_resources(log_text):
    """{instance (mangled): (registers, spill bytes)} from a ptxas -v log."""
    import re
    out, cur, spill = {}, None, 0
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = (int(m.group(1)), spill)
    return out


def sass_mma_counts(so_path):
    """{instance (mangled): (HMMA, HGMMA)} counted in ``cuobjdump -sass`` of
    a built library, or None where the toolkit has no cuobjdump or it
    fails."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    res = subprocess.run([tool, "-sass", str(so_path)], capture_output=True,
                         text=True)
    if res.returncode != 0:
        return None
    out, cur = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            out[cur] = [0, 0]
        elif cur and "HGMMA" in line:
            out[cur][1] += 1
        elif cur and "HMMA" in line:
            out[cur][0] += 1
    return {k: tuple(v) for k, v in out.items()}


def demangle(names):
    import shutil
    if not names or not shutil.which("c++filt"):
        return {n: n for n in names}
    res = subprocess.run(["c++filt"], input="\n".join(names), text=True,
                         capture_output=True)
    return dict(zip(names, res.stdout.splitlines()))


def build_report(libs):
    """Print each kernel instance's registers, spills and tensor-core
    instruction counts.  Fails if a library has no ptxas report, if an
    instance of ``NO_SPILL_INSTANCES`` is missing or spills, or if a
    tensor-core instance has no SASS to count or holds no mma
    instruction."""
    seen, faults = set(), []
    for lib in libs.values():
        res = ptxas_resources(lib.ptxas_log)
        check(bool(res), f"{lib.name}: no ptxas report beside "
                         f"{lib.library_path().name}")
        sass = sass_mma_counts(lib.library_path())
        names = demangle(list(res))
        for fn, (regs, spill) in res.items():
            mma = None if sass is None else sass.get(fn, (0, 0))
            short = names[fn].replace("(anonymous namespace)::", "").split("(")[0]
            short = short.removeprefix("void ")
            log(f"  {lib.name}: {short}: {regs} registers, {spill} spill bytes, "
                + ("SASS not read (no cuobjdump)" if mma is None else
                   f"SASS HMMA {mma[0]}, HGMMA {mma[1]}"))
            held = [t for t in NO_SPILL_INSTANCES if t in fn]
            seen.update(held)
            if held and spill:
                faults.append(f"{short} spills {spill} bytes")
            if set(held) & set(TENSOR_CORE_INSTANCES):
                if mma is None:
                    faults.append(f"{short}: SASS not read")
                elif not sum(mma):
                    faults.append(f"{short}: no tensor-core instruction in its SASS")
    check(not faults, "; ".join(faults))
    check(seen == set(NO_SPILL_INSTANCES),
          f"instances not built: {set(NO_SPILL_INSTANCES) - seen}")


KERNEL_ROWS = {   # name -> (source, the TPU kernel it replaces)
    "swan_decode": ("src/repro_torch/kernels/swan_decode/csrc/swan_decode.cu",
                    "src/repro/kernels/swan_decode/swan_decode.py:196"),
    "swan_decode_paged": ("src/repro_torch/kernels/swan_decode/csrc/swan_decode.cu",
                          "src/repro/kernels/swan_decode/swan_decode.py:266"),
    "swan_chunk_stats": ("src/repro_torch/kernels/swan_chunk/csrc/swan_chunk.cu",
                         "src/repro/kernels/flash_prefill/swan_chunk.py:196"),
    "swan_chunk_stats_paged": ("src/repro_torch/kernels/swan_chunk/csrc/swan_chunk.cu",
                               "src/repro/kernels/flash_prefill/swan_chunk.py:241"),
    "flash_attention": ("src/repro_torch/kernels/flash_prefill/csrc/flash_prefill.cu",
                        "src/repro/kernels/flash_prefill/flash_prefill.py:113"),
    "swan_prune": ("src/repro_torch/kernels/swan_prune/csrc/swan_prune.cu",
                   "src/repro/kernels/swan_prune/swan_prune.py:58"),
}
PHASES = ("kernels", "bench", "serve", "exact", "engine", "graphs",
          "sharded", "audit",
          "dense", "moe", "vlm", "encdec", "hybrid", "ssm", "chunk_exact",
          "obs", "train")


def bench_summary():
    """The port's bench harness folds the artifacts the bench and train
    phases wrote (``build/bench_out``) into ``BENCH_SUMMARY_torch.json``
    (``repro_torch.benchmarks.run.aggregate``): every artifact ok, no gate
    failed."""
    import os
    from repro_torch.benchmarks.run import SUMMARY, aggregate
    os.environ["REPRO_BENCH_OUT"] = str(Path(__file__).resolve().parent
                                        / "build" / "bench_out")
    summary = aggregate()
    log(f"[bench summary] {summary['n_benches']} artifacts "
        f"({', '.join(sorted(summary['benches']))}), {summary['n_gates']} "
        f"gates, {len(summary['gates_failed'])} failed -> "
        f"{os.environ['REPRO_BENCH_OUT']}/{SUMMARY}")
    check(summary["n_benches"] > 0 and summary["all_ok"]
          and not summary["gates_failed"],
          f"bench summary: {summary['gates_failed']}, all_ok "
          f"{summary['all_ok']}")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all); a "
                         "partial run prints no result line")
    args = ap.parse_args(argv)
    phases = args.only.split(",")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.build import build_all

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {kind} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    build_all(KERNELS)
    libs = {k.library.name: k.library for k in KERNELS}
    log(f"[build] {len(libs)} kernel libraries ({', '.join(libs)}), one nvcc "
        f"each, in parallel: {time.perf_counter() - t0:.1f} s")
    build_report(libs)

    err, rows = {}, {}
    by_path = {}          # kernel -> {main path: launches in its run}

    def record(path, counts):
        for name, n in counts.items():
            if n:
                by_path.setdefault(name, {})[path] = n

    secs, mark = {"build": time.perf_counter() - t0}, [time.perf_counter()]

    def lap(name):                      # the seconds of the phase just run
        now = time.perf_counter()
        secs[name] = round(now - mark[0], 1)
        mark[0] = now

    if "kernels" in phases:
        log("[kernels] swan_decode vs plain (B=4 Kv=8 G=4 dh=128 k=64 b=128 S=4096)")
        e, r = kernel_phase()
        err["swan_decode"], rows["swan_decode"] = e["bf16"], r["bf16"]
        log(f"[kernels] swan_decode_paged vs plain and vs swan_decode (page "
            f"size {PS}, {PG} table entries, {N_PAGES} pool pages)")
        e, rows["swan_decode_paged"] = paged_decode_phase()
        err["swan_decode_paged"] = e["bf16"]
        log(f"[kernels] swan_chunk_stats(_paged) vs plain (P={P_CHUNK} "
            f"Q={Q_CHUNK} dh={DH} k={K}, slab {CS} rows / {CPG} pages)")
        e, r = chunk_phase()
        rows.update(r)
        err["swan_chunk_stats"] = err["swan_chunk_stats_paged"] = e["bf16"]
        log(f"[kernels] flash_attention vs plain (B={FB} H={FH} Kv={KV} dh={DH}; "
            f"(Sq, Sk) in {F_CASES}; causal and full; f32 and bf16)")
        e, rows["flash_attention"] = flash_phase()
        err["flash_attention"] = e["bf16"]
        log(f"[kernels] swan_prune vs plain (B={PB_} Kv={KV} S={PS_} dh={DH}, "
            f"k in (1, {PK_}, {DH}); edges (B, Kv, S, dh) in {P_EDGES}; f32 "
            "and bf16)")
        e, rows["swan_prune"] = prune_phase()
        err["swan_prune"] = e["bf16"]
        log(f"[kernels] B1-B4 at the served archs' other query groups, "
            f"b={BUF}: (arch, Kv, G, d_head, k) in {SERVED_GROUPS}")
        e = served_groups_phase()
        for name in ("swan_decode", "swan_decode_paged"):
            err[name] = max(err[name], e["bf16"])
        for name in ("swan_chunk_stats", "swan_chunk_stats_paged"):
            err[name] = max(err[name], e["chunk_bf16"])
        log(f"[kernels] B1/B2 at G in {GROUP_SIZES} (no CUDA instance: the "
            f"padded plan), Kv=2 dh=64 k=32 b={BUF}, every value type")
        e, _ = group_sizes_phase()
        for name in ("swan_decode", "swan_decode_paged"):
            err[name] = max(err[name], e["bf16"])
        lap("kernels")
    if "bench" in phases:
        log("[bench] repro_torch.benchmarks.bench_kernels at full llama3-8b "
            "width (bf16)")
        record("bench", bench_phase(KERNELS))
        lap("bench")
    model = (served_model("llama3-8b") if {"serve", "engine", "graphs",
                                            "sharded", "audit"}
             & set(phases) else None)
    warmed = {}
    if "serve" in phases:
        log("[serve] llama3-8b, SWAN k=64 b=128, lockstep ServeSession")
        record("serve", serve_phase(KERNELS, model))
        lap("serve (with the model's init)")
    if "exact" in phases:
        log("[exact] 4 layers at full width, SWAN k=d_head vs dense cache")
        worst = exact_phase(KERNELS)
        log(f"  worst relative logit error {worst:.4f}")
        lap("exact")
    if {"engine", "graphs"} & set(phases):
        log("[engine] llama3-8b, ServeEngine (4 slots, chunk 256 x 2 lanes), "
            "slab then paged, eager")
        counts_by_path, eager_runs = engine_phase(
            KERNELS, model, keep_rows="sharded" in phases)
        for path, counts in counts_by_path.items():
            record(path, counts)
        lap("engine")
    if "graphs" in phases:
        log("[graphs] llama3-8b: the lockstep session eager and graphed")
        record("graphs_lockstep", lockstep_graphs(KERNELS, model)[0])
        log(f"[graphs] ServeEngine graphed, slab then paged, after "
            f"warmup(max_prompt_len={WARM_PROMPT})")
        counts_by_path, on_off, warmed = engine_graphs(
            KERNELS, model, eager_runs, keep="audit" in phases)
        for path, counts in counts_by_path.items():
            record(path, counts)
        lap("graphs")
    if "sharded" in phases:
        log(f"[sharded] llama3-8b, ServeEngine over make_serve_mesh"
            f"({SHARDS}, devices=['cuda:0'] * {SHARDS}): paged graphed after "
            f"warmup(max_prompt_len={WARM_PROMPT}), slab graphed at first "
            "use, paged eager; against dp = 1")
        first = ({lay: r["off"][0] for lay, r in on_off.items()}
                 if "graphs" in phases else None)
        counts_by_path, kept = sharded_phase(
            KERNELS, model,
            eager_runs if {"engine", "graphs"} & set(phases) else None,
            first, audit="audit" in phases)
        for path, counts in counts_by_path.items():
            record(path, counts)
        if kept is not None:            # the audit phase's, then freed
            warmed["paged-dp2"] = kept
        del kept
        lap("sharded")
    if "audit" in phases:
        log("[audit] the serve auditor at llama3-8b's full width: slab and "
            f"{PS}-token pages graphed after warmup(max_prompt_len="
            f"{WARM_PROMPT}), plain reads eager; roofline rows")
        record("audit", audit_phase(KERNELS, model, warmed))
        warmed.clear()
        gc.collect()
        torch.cuda.empty_cache()
        roofline_rows(KERNELS, model, smi)
        lap("audit")
    warmed.clear()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    if "dense" in phases:
        mark[0] = time.perf_counter()
        for path, counts in dense_phase(KERNELS).items():
            record(path, counts)
        lap("dense")
    if "moe" in phases:
        mark[0] = time.perf_counter()
        for path, counts in moe_phase(KERNELS).items():
            record(path, counts)
        lap("moe")
    if "vlm" in phases:
        mark[0] = time.perf_counter()
        for path, counts in vlm_phase(KERNELS).items():
            record(path, counts)
        lap("vlm")
    if "encdec" in phases:
        mark[0] = time.perf_counter()
        for path, counts in encdec_phase(KERNELS).items():
            record(path, counts)
        lap("encdec")
    if "hybrid" in phases:
        mark[0] = time.perf_counter()
        for path, counts in hybrid_phase(KERNELS).items():
            record(path, counts)
        lap("hybrid")
    if "ssm" in phases:
        mark[0] = time.perf_counter()
        ssm_phase(KERNELS)
        lap("ssm")
    if "chunk_exact" in phases:
        log("[chunk_exact] 4 layers at full width, k=d_head: chunked prefill "
            "(slab, paged) vs the dense monolithic prefill")
        worst = chunk_exact_phase(KERNELS)
        log(f"  worst relative logit error {worst:.4f}")
        lap("chunk_exact")
    if "obs" in phases:
        log("[obs] the launcher: llama3-8b, --engine --paged --prefill-chunk "
            "256, graphed without a warmup, with --metrics-out, --trace-out "
            "and --profile-steps 4")
        record("obs_launcher", obs_phase(KERNELS))
        if "graphs" in phases:
            log_on_off(on_off, smi)
        lap("obs")
    if "train" in phases:
        record("quality", train_phase(KERNELS, smi))
        lap("train")
    if {"bench", "train"} & set(phases):
        bench_summary()
    log(f"[done] {time.perf_counter() - t_start:.1f} s; by phase (s): {secs}")
    if set(phases) != set(PHASES):
        return 0                        # a partial run prints no result

    check(set(by_path) == set(KERNEL_ROWS),
          f"a kernel ran on no main path: {by_path}")
    print(smi)                          # the card's name and power limit
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(by_path[name].values()),
         "launches_by_path": by_path[name], "max_abs_err": err[name],
         **rows[name]}
        for name, (src, rep) in KERNEL_ROWS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
