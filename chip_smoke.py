#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. device   — the card's name and power limit (nvidia-smi) and torch's name.
2. build    — every CUDA kernel of the port, built from the sources in this
              checkout (one nvcc per source, all started together).
3. kernels  — each kernel against its plain PyTorch version on the card, at
              the shapes the serve path gives it, for every value type it
              takes; its median time beside the plain version's, a one-call
              PyTorch yardstick (``library_ms``) and the byte bound.
4. serve    — full-width llama3-8b (bf16, seeded random weights) served
              through the lockstep SWAN path: calibrate, absorb,
              ``ServeSession.generate``.  The kernel launch counts are zeroed
              just before ``generate`` and read just after.
5. exact    — 4 layers at full width, SWAN at full retention (k = d_head)
              against the dense-cache session: the decode logits must agree
              (Lemmas A.1/A.2), with the decode kernel on the path.

The last three lines are nvidia-smi's name and power limit of the card,
one JSON object of kernel numbers, and the result line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
non-zero and prints no result.
"""
from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
L2_FLUSH_BYTES = 256 << 20       # > the 50 MB L2: each timed launch starts cold

# the serve phase's shapes (llama3-8b, SwanConfig(k_max=64, buffer=128))
B, KV, G, DH, K, BUF, S = 4, 8, 4, 128, 64, 128, 4096
PROMPT, NEW_TOKENS = 2048, 64


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, reps: int, flush=None) -> float:
    """Median device time of ``fn`` over ``reps`` launches (CUDA events),
    with the L2 cache flushed before each launch when ``flush`` is given."""
    import torch
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


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


def decode_inputs(kind: str, pos, gen):
    """Operands of one decode read at the serve shapes.  kind: value storage
    (bf16 / int8 / fp8 with bf16 q, or f32 throughout)."""
    import torch
    qdt = torch.float32 if kind == "f32" else torch.bfloat16
    dev = "cuda"
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    idx = lambda: torch.rand((B, KV, S, DH), generator=gen, device=dev
                             ).argsort(-1)[..., :K].to(torch.int8)
    a = {"q": rnd(B, KV, G, DH).to(qdt), "k_idx": idx(), "v_idx": idx(),
         "buf_k": rnd(B, KV, BUF, DH).to(qdt), "buf_v": rnd(B, KV, BUF, DH).to(qdt),
         "buf_pos": ring_positions(pos, BUF),
         "pos": torch.tensor(pos, dtype=torch.int32, device=dev)}
    a["sp_len"] = torch.clamp(a["pos"] + 1 - BUF, min=0).to(torch.int32)
    for s in "kv":
        if kind == "int8":
            a[f"{s}_vals"] = torch.randint(-127, 128, (B, KV, S, K), generator=gen,
                                           device=dev).to(torch.int8)
            a[f"{s}_scale"] = rnd(B, KV, S).abs() * 0.05 + 0.01
        elif kind == "fp8":
            a[f"{s}_vals"] = rnd(B, KV, S, K).to(torch.float8_e4m3fn)
        else:
            a[f"{s}_vals"] = rnd(B, KV, S, K).to(qdt)
    return a


ARGS = ("q", "k_vals", "k_idx", "v_vals", "v_idx", "buf_k", "buf_v",
        "buf_pos", "pos", "sp_len")


def call(fn, a):
    return fn(*[a[n] for n in ARGS], k_scale=a.get("k_scale"),
              v_scale=a.get("v_scale"))


def decode_bytes_flops(a):
    """Bytes the function must move (each input once, the output once;
    sparse rows counted only below sp_len) and its float operations."""
    rows = int(a["sp_len"].sum()) * KV
    per_row = 2 * K * (a["k_vals"].element_size() + 1)
    if "k_scale" in a:
        per_row += 2 * 4
    ring = sum(a[n].numel() * a[n].element_size()
               for n in ("buf_k", "buf_v", "buf_pos"))
    qo = 2 * a["q"].numel() * a["q"].element_size()
    valid_slots = int(((a["buf_pos"] >= 0)
                       & (a["buf_pos"] <= a["pos"][:, None])).sum()) * KV
    flops = 4 * G * (rows * K + valid_slots * DH)
    return rows * per_row + ring + qo + 8 * B, flops


def sdpa_yardstick(a):
    """The same function as one scaled_dot_product_attention call over the
    dense-expanded [sparse ‖ ring] keys/values (expansion done here, outside
    the timed call).  Returns (closure, output)."""
    import torch
    import torch.nn.functional as F

    def dense(vals, idx, scale):
        v = vals.float() if scale is None else vals.float() * scale[..., None]
        out = torch.zeros((B, KV, S, DH), device="cuda")
        return out.scatter_(-1, idx.long(), v)

    kd = dense(a["k_vals"], a["k_idx"], a.get("k_scale"))
    vd = dense(a["v_vals"], a["v_idx"], a.get("v_scale"))
    qdt = a["q"].dtype
    k_all = torch.cat([kd, a["buf_k"].float()], 2).to(qdt)
    v_all = torch.cat([vd, a["buf_v"].float()], 2).to(qdt)
    k_all = k_all.repeat_interleave(G, dim=1).contiguous()   # [B, H, S+b, dh]
    v_all = v_all.repeat_interleave(G, dim=1).contiguous()
    q = a["q"].reshape(B, KV * G, 1, DH)
    t = torch.arange(S, device="cuda")
    mask = torch.cat([t[None] < a["sp_len"][:, None],
                      (a["buf_pos"] >= 0) & (a["buf_pos"] <= a["pos"][:, None])],
                     1)[:, None, None, :]                       # [B,1,1,S+b]
    fn = lambda: F.scaled_dot_product_attention(q, k_all, v_all, attn_mask=mask)
    return fn, fn().reshape(B, KV, G, DH)


def kernel_phase():
    import torch
    from repro_torch.kernels.swan_decode.swan_decode import (swan_decode,
                                                             swan_decode_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tol = {"f32": 1e-5, "bf16": 1e-2, "int8": 1e-2, "fp8": 1e-2}
    cases = {
        "sp_len=0, ring part filled": [0, 5, 60, BUF - 1],
        "per-sequence pos": [PROMPT + NEW_TOKENS - 2, 1000, 3000, S - 7],
        "full-length prefix": [S + BUF - 1] * B,
    }
    max_err = {}
    for kind in ("bf16", "int8", "fp8", "f32"):
        for case, pos in cases.items():
            a = decode_inputs(kind, pos, gen)
            got = call(swan_decode, a).float()
            want = call(swan_decode_plain, a).float()
            torch.cuda.synchronize()
            err = (got - want).abs()
            bad = err > tol[kind] * (1 + want.abs())
            log(f"  swan_decode[{kind:4s}] {case:27s} max_abs_err "
                f"{err.max().item():.3e} (tol {tol[kind]:g} abs+rel)")
            check(bool(torch.isfinite(got).all()) and not bool(bad.any()),
                  f"swan_decode[{kind}] {case}: kernel disagrees with plain")
            max_err[kind] = max(max_err.get(kind, 0.0), err.max().item())

    # timing at the serve phase's last decode step (lockstep, bf16 values)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = {}
    for kind in ("bf16", "int8", "fp8"):
        a = decode_inputs(kind, [PROMPT + NEW_TOKENS - 2] * B, gen)
        nbytes, flops = decode_bytes_flops(a)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        bound = max(t_bytes, t_ops) * 1e3
        ms = time_ms(lambda: call(swan_decode, a), 50, flush)
        plain_ms = time_ms(lambda: call(swan_decode_plain, a), 10, flush)
        lib_fn, lib_out = sdpa_yardstick(a)
        lib_err = (lib_out.float() - call(swan_decode_plain, a).float()).abs().max()
        lib_ms = time_ms(lib_fn, 20, flush)
        log(f"  swan_decode[{kind:4s}] serve shape (sp_len "
            f"{int(a['sp_len'][0])}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms (expansion excluded; |sdpa-plain| "
            f"{lib_err.item():.2e}), bound {bound:.4f} ms ({nbytes} B, "
            f"{100 * bound / ms:.1f}% of bound)")
        rows[kind] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                      "library_ms": lib_ms}
    del flush
    return max_err, rows


# ---------------------------------------------------------------------------
# phases 4-5: serving
# ---------------------------------------------------------------------------

def serve_phase(kernels):
    import torch
    from repro_torch.configs import SwanConfig, get_config
    from repro_torch.launch.io import make_batch
    from repro_torch.models.registry import get_model
    from repro_torch.runtime.serve_loop import ServeSession, calibrate_swan

    cfg = get_config("llama3-8b")
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = api.init_params(cfg, 0, "cuda")
    projections = calibrate_swan(api, cfg, params,
                                 make_batch(cfg, 4, 64, seed=3, device="cuda"))
    params = api.absorb(params, cfg, projections)
    torch.cuda.synchronize()
    log(f"  init + calibrate + absorb: {time.perf_counter() - t0:.1f} s "
        f"({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype})")
    swan = SwanConfig(k_max=K, buffer=BUF, mode="topk")
    sess = ServeSession(cfg, params, swan=swan, projections=projections,
                        max_seq=S, batch=B, device="cuda")
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
    check(launches["swan_decode"] == cfg.n_layers * steps,
          f"swan_decode launched {launches['swan_decode']} times, expected "
          f"{cfg.n_layers} x {steps}")
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
    del sess, params, projections, logits
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def profile_decode(sess, tok, steps: int) -> None:
    """Trace ``steps`` more greedy decode steps with torch.profiler: the ops
    by device time, the card's busy share of the traced wall time and the
    decode kernel's share of the device time.  The profiler slows the host,
    so the busy share is a floor."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = torch.argmax(sess.decode(tok).float(), dim=-1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    log(ka.table(sort_by="self_device_time_total", row_limit=12))
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    swan = sum(e.self_device_time_total for e in kernels
               if "swan_decode_kernel" in e.key) / 1e3
    n_ops = sum(e.count for e in ka if e.key.startswith("aten::")) / steps
    if busy == 0:
        log("  profile: the profiler traced no device time")
        return
    log(f"  profile: {steps} decode steps, {wall_ms / steps:.1f} ms/step wall "
        f"(traced), card busy {busy / steps:.1f} ms/step "
        f"({100 * busy / wall_ms:.1f}%), swan_decode {swan / steps:.1f} ms/step "
        f"({100 * swan / busy:.1f}% of device time), {n_ops:.0f} aten ops/step")


def exact_phase(kernels):
    import torch
    from repro_torch.configs import SwanConfig, get_config
    from repro_torch.launch.io import make_batch
    from repro_torch.models.registry import get_model
    from repro_torch.runtime.serve_loop import ServeSession, calibrate_swan

    cfg = get_config("llama3-8b").replace(n_layers=4)
    api = get_model(cfg)
    params = api.init_params(cfg, 1, "cuda")
    proj = calibrate_swan(api, cfg, params,
                          make_batch(cfg, 4, 64, seed=3, device="cuda"))
    absorbed = api.absorb(params, cfg, proj)
    full = SwanConfig(k_max=cfg.d_head, buffer=BUF, mode="topk")
    s_swan = ServeSession(cfg, absorbed, swan=full, projections=proj,
                          max_seq=1024, batch=B, device="cuda")
    s_dense = ServeSession(cfg, params, max_seq=1024, batch=B, device="cuda")
    prompt = make_batch(cfg, B, 512, seed=5, device="cuda")
    ld, ls = s_dense.prefill(prompt), s_swan.prefill(prompt)
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
    check(kern.launches - before == cfg.n_layers * 8,
          "the exactness decode did not go through the kernel")
    return worst


def main() -> int:
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
    log(f"[build] {len(KERNELS)} kernel librar{'y' if len(KERNELS) == 1 else 'ies'} "
        f"in {time.perf_counter() - t0:.1f} s")
    for k in KERNELS:
        for line in k.ptxas_log.splitlines():
            if "registers" in line or "spill" in line and " 0 bytes" not in line:
                log(f"  {k.name}: {line.strip()}")

    log("[kernels] swan_decode vs plain (B=4 Kv=8 G=4 dh=128 k=64 b=128 S=4096)")
    max_err, rows = kernel_phase()

    log("[serve] llama3-8b, SWAN k=64 b=128, lockstep ServeSession")
    launches = serve_phase(KERNELS)

    log("[exact] 4 layers at full width, SWAN k=d_head vs dense cache")
    worst = exact_phase(KERNELS)
    log(f"  worst relative logit error {worst:.4f}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    bf16 = rows["bf16"]
    print(smi)                          # the card's name and power limit
    print(json.dumps({"kernels": [{
        "name": "swan_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/swan_decode/csrc/swan_decode.cu",
        "replaces": "src/repro/kernels/swan_decode/swan_decode.py:196",
        "launches": launches["swan_decode"], "max_abs_err": max_err["bf16"],
        "ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"],
        "library_ms": bf16["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
