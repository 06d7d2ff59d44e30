"""Kernel microbenchmarks + per-kernel roofline table (port of
``benchmarks/bench_kernels.py``).

Each of the port's six kernels gets a ROOFLINE row: the ideal device-byte
and operation model of ``repro_torch.analysis.roofline`` gives a floor time
on one H100, and ``achieved_fraction`` = floor / measured.  Rows cover the
decode kernel per (k, layout) — the paged layout per page bucket — the
chunk-prefill stats kernel (slab, and paged through page-table rows),
causal flash prefill and fused winnowing.  The reference's rows keep their
names; the paged chunk and the prune rows are the port's own (the
reference times its prune kernel only as a legacy row and never its paged
chunk kernel).  The legacy rows time the plain paths the kernels replace,
with the reference's ``xla`` read as ``torch`` and its
``swan_prune_pallas_interpret`` renamed ``swan_prune_kernel``.

On the card every call is timed with CUDA events (median, L2 flushed);
with ``--device cpu`` the kernels' plain twins run and the times are CPU
wall times, whose roofline fractions are consistency numbers only.  The
gate asks every fraction to be finite and positive and, on the card at
full width, the kernels with an H100 floor (``H100_FLOORS``) to reach it.

    python -m repro_torch.benchmarks.bench_kernels [--smoke] [--device cpu]

``--smoke`` runs the reference's own smoke shapes in f32; the default runs
full llama3-8b width in bf16.  ``BENCH_kernels_torch.json`` lands in
``$REPRO_BENCH_OUT`` (default ``bench_out/``), the roofline table under
``extra.roofline``.
"""
from __future__ import annotations

import argparse
import math
from dataclasses import dataclass
from typing import List, Tuple

import torch

from repro_torch.analysis import roofline as rl
from repro_torch.benchmarks.common import (BenchRecorder, bench_record, emit,
                                           gate, timeit_call)
from repro_torch.configs import (ModelConfig, SwanConfig, get_config,
                                 get_smoke_config)
from repro_torch.core import hybrid_cache as hc
from repro_torch.core import swan_attention as swa
from repro_torch.core.analytical import sparse_vector_bytes
from repro_torch.core.winnow import rotate_k, topk_pack
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_prefill.ops import flash_attention
from repro_torch.kernels.swan_chunk.ops import (swan_chunk_stats,
                                                swan_chunk_stats_paged)
from repro_torch.kernels.swan_decode.ops import (
    swan_decode_attention_kernel, swan_decode_attention_kernel_paged)
from repro_torch.kernels.swan_prune.ops import swan_prune
from repro_torch.models.attention import blocked_attention
from repro_torch.models.common import torch_dtype


@dataclass(frozen=True)
class Shapes:
    """One run's shapes: the reference's smoke shapes, or full width."""
    arch_cfg: ModelConfig     # Kv, G, dh and the operands' dtype
    dec_B: int
    dec_S: int
    dec_buffer: int
    dec_ks: Tuple[int, ...]
    page_size: int
    page_buckets: Tuple[int, ...]
    chunk_P: int
    chunk_Q: int
    chunk_S: int
    chunk_k: int
    flash: Tuple[int, int, int, int, int]    # B, Sq (= Sk), H, Kv, dh
    flash_block: int
    prune: Tuple[int, int, int, int, int]    # B, Kv, S, dh, k
    prune_tile: int
    iters: int
    warmup: int


def shapes(smoke: bool) -> Shapes:
    if smoke:   # benchmarks/bench_kernels.py's own --smoke shapes
        return Shapes(get_smoke_config("llama3-8b").replace(dtype="float32"),
                      dec_B=2, dec_S=128, dec_buffer=16, dec_ks=(8,),
                      page_size=32, page_buckets=(2, 4), chunk_P=2, chunk_Q=8,
                      chunk_S=64, chunk_k=8, flash=(1, 128, 4, 2, 32),
                      flash_block=64, prune=(2, 2, 128, 32, 8), prune_tile=64,
                      iters=2, warmup=1)
    # full llama3-8b width (bf16): the serve path's decode (b=128, S=4096,
    # 64-row pages), the engine's chunk (2 lanes x 256 tokens x G=4 over a
    # 2048-row prefix) and a 4 x 2048-token prefill
    return Shapes(get_config("llama3-8b"), dec_B=4, dec_S=4096, dec_buffer=128,
                  dec_ks=(32, 64), page_size=64, page_buckets=(32, 64),
                  chunk_P=2, chunk_Q=1024, chunk_S=2048, chunk_k=64,
                  flash=(4, 2048, 32, 8, 128), flash_block=256,
                  prune=(4, 8, 2048, 128, 64), prune_tile=256, iters=20,
                  warmup=3)


class _Inputs:
    """Seeded operands on one device (a generator on that device)."""

    def __init__(self, device: torch.device, dtype: torch.dtype, seed: int):
        self.device, self.dtype = device, dtype
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def normal(self, *shape, dtype=None) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device
                           ).to(dtype or self.dtype)

    def idx(self, *lead, k: int, dh: int) -> torch.Tensor:
        """Distinct packed indices per vector, as winnowing makes them."""
        return torch.rand((*lead, dh), generator=self.gen, device=self.device
                          ).argsort(-1)[..., :k].to(torch.int8)

    def orthogonal(self, n: int, dh: int) -> torch.Tensor:
        """n random orthogonal [dh, dh] f32 matrices (QR of a normal)."""
        a = torch.randn((n, dh, dh), generator=self.gen, device=self.device)
        qm, r = torch.linalg.qr(a)
        return (qm * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None]
                ).contiguous()


def _emit_roofline(rec: BenchRecorder, row) -> float:
    rec.extra.setdefault("roofline", []).append(row)
    emit(f"roofline_{row['name']}", row["us_per_call"],
         f"bytes={row['hbm_bytes']}_floor_us={row['floor_us']:.2f}"
         f"_frac={row['achieved_fraction']:.2e}_bound={row['bound']}")
    return row["achieved_fraction"]


def _decode_rooflines(rec, sh: Shapes, dev) -> List[float]:
    """Decode kernel rows: slab per k, paged per (k, page bucket)."""
    cfg = sh.arch_cfg
    B, bt, S, ps = sh.dec_B, sh.dec_buffer, sh.dec_S, sh.page_size
    Kv, G, dh = cfg.n_kv_heads, cfg.q_group, cfg.d_head
    t = _Inputs(dev, torch_dtype(cfg.dtype), 0)
    vb = t.dtype.itemsize
    fracs = []
    for k in sh.dec_ks:
        swan = SwanConfig(k_max=k, buffer=bt, mode="topk")
        kh, vh = t.normal(B, S - 8, Kv, dh), t.normal(B, S - 8, Kv, dh)
        cache = hc.init_swan_cache(cfg, swan, B, S, dev)
        hc.swan_cache_insert_prefill_(cache, swan, kh, vh)
        q = t.normal(B, Kv, G, dh)
        pos = S - 9
        us = timeit_call(lambda: swan_decode_attention_kernel(q, cache, swan,
                                                              pos),
                         iters=sh.iters, warmup=sh.warmup)
        # the kernel reads the packed rows below sp_len = pos + 1 - b only
        nb = rl.swan_decode_kernel_bytes(B=B, Kv=Kv, G=G, dh=dh,
                                         S=pos + 1 - bt, k_max=k,
                                         buffer=bt, quantized=False,
                                         val_bytes=vb, act_bytes=vb)
        fracs.append(_emit_roofline(rec, rl.roofline_row(
            f"swan_decode_slab_k{k}", us, nb, kernel="swan_decode",
            layout="slab", k=k)))
        for pb in sh.page_buckets:
            n_pages = B * pb + 1
            side = {"vals": t.normal(n_pages, Kv, ps, k),
                    "idx": t.idx(n_pages, Kv, ps, k=k, dh=dh)}
            pcache = {"pool": {"k": side, "v": dict(side)},
                      "buf_k": t.normal(B, Kv, bt, dh),
                      "buf_v": t.normal(B, Kv, bt, dh),
                      "buf_pos": (pb * ps + torch.arange(
                          bt, dtype=torch.int32, device=dev))[None].repeat(B, 1)}
            tab = (1 + torch.arange(B * pb, dtype=torch.int32, device=dev)
                   ).reshape(B, pb)
            ppos = pb * ps + bt - 1
            us = timeit_call(lambda: swan_decode_attention_kernel_paged(
                q, pcache, swan, ppos, tab), iters=sh.iters, warmup=sh.warmup)
            nb = rl.swan_decode_kernel_bytes(B=B, Kv=Kv, G=G, dh=dh,
                                             S=pb * ps, k_max=k, buffer=bt,
                                             quantized=False, val_bytes=vb,
                                             act_bytes=vb)
            fracs.append(_emit_roofline(rec, rl.roofline_row(
                f"swan_decode_paged_k{k}_pg{pb}", us, nb,
                kernel="swan_decode_paged", layout="paged", k=k,
                page_bucket=pb, page_size=ps)))
    return fracs


def _to_pages(x: torch.Tensor, ps: int) -> torch.Tensor:
    """Slab rows [P, Kv, S, ...] -> a pool [1 + P·S/ps, Kv, ps, ...] whose
    page 1 + p·(S/ps) + j holds lane p's rows [j·ps, (j+1)·ps); page 0 is
    the trash page (zeros)."""
    P, Kv, S = x.shape[:3]
    tail = tuple(x.shape[3:])
    pages = x.reshape(P, Kv, S // ps, ps, *tail).transpose(1, 2) \
        .reshape(P * (S // ps), Kv, ps, *tail)
    return torch.cat([torch.zeros_like(pages[:1]), pages])


def _chunk_rooflines(rec, sh: Shapes, dev) -> List[float]:
    """Chunk-prefill stats kernel rows (the engine's chunk dispatch): slab,
    and the same prefix through page-table rows."""
    cfg = sh.arch_cfg
    P, Q, S, k, ps = sh.chunk_P, sh.chunk_Q, sh.chunk_S, sh.chunk_k, sh.page_size
    Kv, dh = cfg.n_kv_heads, cfg.d_head
    t = _Inputs(dev, torch_dtype(cfg.dtype), 7)
    q = t.normal(P, Kv, Q, dh, dtype=torch.float32)
    kv, vv = t.normal(P, Kv, S, k), t.normal(P, Kv, S, k)
    ki = t.idx(P, Kv, S, k=k, dh=dh)
    sp = torch.full((P,), S, dtype=torch.int32, device=dev)
    nb = rl.swan_chunk_kernel_bytes(B=P, Kv=Kv, Q=Q, dh=dh, S=S, k_max=k,
                                    quantized=False,
                                    val_bytes=t.dtype.itemsize)
    us = timeit_call(lambda: swan_chunk_stats(q, kv, ki, vv, ki, sp),
                     iters=sh.iters, warmup=sh.warmup)
    fracs = [_emit_roofline(rec, rl.roofline_row(
        f"swan_chunk_stats_S{S}_k{k}", us, nb, kernel="swan_chunk_stats",
        layout="slab", k=k))]
    pkv, pvv, pki = _to_pages(kv, ps), _to_pages(vv, ps), _to_pages(ki, ps)
    rows = (1 + torch.arange(P * (S // ps), dtype=torch.int32, device=dev)
            ).reshape(P, S // ps)
    us = timeit_call(lambda: swan_chunk_stats_paged(q, pkv, pki, pvv, pki, sp,
                                                    rows),
                     iters=sh.iters, warmup=sh.warmup)
    fracs.append(_emit_roofline(rec, rl.roofline_row(
        f"swan_chunk_stats_paged_S{S}_k{k}", us, nb,
        kernel="swan_chunk_stats_paged", layout="paged", k=k,
        page_size=ps)))
    return fracs


def _flash_roofline(rec, sh: Shapes, dev) -> List[float]:
    B, Sq, H, Kv, dh = sh.flash
    t = _Inputs(dev, torch_dtype(sh.arch_cfg.dtype), 9)
    q, kf, vf = t.normal(B, Sq, H, dh), t.normal(B, Sq, Kv, dh), \
        t.normal(B, Sq, Kv, dh)
    us = timeit_call(lambda: flash_attention(q, kf, vf, block_q=sh.flash_block,
                                             block_k=sh.flash_block),
                     iters=sh.iters, warmup=sh.warmup)
    nb = rl.flash_kernel_bytes(B=B, H=H, Kv=Kv, Sq=Sq, Sk=Sq, dh=dh,
                               dtype_bytes=t.dtype.itemsize)
    fl = rl.flash_kernel_flops(B=B, H=H, Sq=Sq, Sk=Sq, dh=dh)
    return [_emit_roofline(rec, rl.roofline_row(
        f"flash_prefill_Sq{Sq}", us, nb, flops=fl, kernel="flash_prefill",
        layout="dense"))]


def _prune_inputs(sh: Shapes, dev):
    B, Kv, S, dh, k = sh.prune
    t = _Inputs(dev, torch_dtype(sh.arch_cfg.dtype), 5)
    return t.normal(B, Kv, S, dh), t.orthogonal(Kv, dh), k


def _prune_roofline(rec, sh: Shapes, dev) -> Tuple[List[float], float]:
    """Fused winnowing row (the reference times its prune kernel only as a
    legacy row, without a bound): ([fraction], us per call)."""
    x, P, k = _prune_inputs(sh, dev)
    B, Kv, S, dh = x.shape
    us = timeit_call(lambda: swan_prune(x, P, k, tile=sh.prune_tile),
                     iters=sh.iters, warmup=sh.warmup)
    nb = rl.swan_prune_kernel_bytes(B=B, Kv=Kv, S=S, dh=dh, k_max=k,
                                    x_bytes=x.element_size(), p_bytes=4)
    fl = rl.swan_prune_kernel_flops(B=B, Kv=Kv, S=S, dh=dh)
    return [_emit_roofline(rec, rl.roofline_row(
        f"swan_prune_S{S}_k{k}", us, nb, flops=fl, kernel="swan_prune",
        layout="dense", k=k))], us


def _legacy_paths(sh: Shapes, dev, prune_us: float) -> None:
    """The plain-path rows (the reference's XLA-vs-interpret comparison):
    they track the pure paths the kernels replace.  The prune kernel's row
    repeats ``prune_us``, its time from the roofline row."""
    cfg = sh.arch_cfg
    B, S, b, k = sh.dec_B, sh.dec_S, sh.dec_buffer, sh.dec_ks[-1]
    Kv, G, dh = cfg.n_kv_heads, cfg.q_group, cfg.d_head
    iters = min(sh.iters, 5)
    swan = SwanConfig(k_max=k, buffer=b, mode="topk")
    t = _Inputs(dev, torch_dtype(cfg.dtype), 0)
    kh, vh = t.normal(B, S - 56, Kv, dh), t.normal(B, S - 56, Kv, dh)
    cache = hc.init_swan_cache(cfg, swan, B, S, dev)
    hc.swan_cache_insert_prefill_(cache, swan, kh, vh)
    q = t.normal(B, Kv, G, dh)
    pos = torch.full((B,), S - 57, dtype=torch.int32, device=dev)
    us = timeit_call(lambda: swa.swan_decode_attention(q, cache, swan, pos),
                     iters=iters, warmup=1)
    sparse_b = 2 * B * Kv * S * sparse_vector_bytes(k)
    dense_b = 2 * B * Kv * S * dh * 2
    emit("swan_decode_torch_ref", us,
         f"S={S}_k={k}_bytes={sparse_b}_vs_dense={dense_b}")

    Bf, Sq, H, Kvf, dhf = sh.flash
    tf = _Inputs(dev, q.dtype, 9)
    qf, kf = tf.normal(Bf, Sq, H, dhf), tf.normal(Bf, Sq, Kvf, dhf)
    us = timeit_call(lambda: blocked_attention(qf, kf, kf, causal=True,
                                               block=sh.flash_block),
                     iters=iters, warmup=1)
    flops = rl.flash_kernel_flops(B=Bf, H=H, Sq=Sq, Sk=Sq, dh=dhf,
                                  causal=False)
    emit("flash_prefill_torch_blocked", us, f"Sq=Sk={Sq}_flops={flops:.0f}")

    x, P, kp = _prune_inputs(sh, dev)
    desc = f"T={x.shape[2]}_dh={x.shape[3]}_k={kp}"
    emit("swan_prune_kernel", prune_us, desc)
    us = timeit_call(lambda: topk_pack(rotate_k(x.transpose(1, 2), P)
                                       .transpose(1, 2), kp),
                     iters=iters, warmup=1)
    emit("swan_prune_torch_ref", us, desc)


# H100 floors of the achieved fraction at full width, per kernel: half of
# what each redesign reached in this bench on an NVIDIA H100 80GB HBM3 at a
# 700 W power limit, measured by chip_smoke.py (PERF.md §6): the tensor-core
# kernels 0.1799, 0.0295, 0.0275; the split-S decode kernels 0.0239, the
# lowest row either reached over two full runs (paged k=64 over 32 pages);
# fused winnowing 0.1033 (its sorting-network redesign's first full run).
# The decode rows are timed with the wrapper's host work, which outlasts
# the L2 flush on a slow host, so both share that lowest row.
H100_FLOORS = {"flash_prefill": 0.09, "swan_chunk_stats": 0.0147,
               "swan_chunk_stats_paged": 0.0137, "swan_decode": 0.012,
               "swan_decode_paged": 0.012, "swan_prune": 0.0516}


def run(smoke: bool = False, device: DeviceLike = None) -> BenchRecorder:
    """Time the six kernels and the plain paths; returns the recorder (its
    ``extra["roofline"]`` rows and ``rows``), after writing the artifact."""
    dev = resolve_device(device)
    sh = shapes(smoke)
    with bench_record("kernels_torch", dev) as rec:
        rec.extra["smoke"] = smoke
        fracs = []
        fracs += _decode_rooflines(rec, sh, dev)
        fracs += _chunk_rooflines(rec, sh, dev)
        fracs += _flash_roofline(rec, sh, dev)
        prune_fracs, prune_us = _prune_roofline(rec, sh, dev)
        fracs += prune_fracs
        # the reference's floor {"tpu": 0.4} is a TPU figure and does not
        # carry over: every row must have a finite, positive fraction, and
        # the kernels that earned an H100 floor must reach it at full width
        # on the card
        worst = min(fracs)
        gate("kernels_roofline_fraction",
             all(math.isfinite(f) for f in fracs) and worst > 0,
             f"device={dev.type}: worst achieved fraction {worst:.3e} must "
             f"be positive over {len(fracs)} kernel rows")
        if dev.type == "cuda" and not smoke:
            low = [f"{r['name']} {r['achieved_fraction']:.4f} < "
                   f"{H100_FLOORS[r['kernel']]}" for r in rec.extra["roofline"]
                   if r["achieved_fraction"] < H100_FLOORS.get(r["kernel"], 0)]
            gate("kernels_h100_floor", not low,
                 f"rows under their H100 floor: {low or 'none'}")
        _legacy_paths(sh, dev, prune_us)
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's small shapes, f32, few iterations")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain twins)")
    args = ap.parse_args()
    run(smoke=args.smoke, device=args.device)
