"""Per-kernel roofline terms on one NVIDIA H100 SXM (port of the kernel part
of ``repro/analysis/roofline.py``, :66-137).

A kernel's floor is the larger of its ideal device-memory bytes over
``HBM_BW`` and its operations over ``PEAK_FLOPS``; ``roofline_row`` puts it
beside a measured time.  The reference models f32 operands throughout; here
the value widths are arguments that default to the reference's f32, so at
the defaults every function gives the reference's number, with two
exceptions: ``flash_kernel_bytes`` counts the k/v bytes of every kv head
(the reference counts one, ``roofline.py:107``), and
``swan_prune_kernel_bytes``/``_flops`` are new (the reference has no bound
for its prune kernel).  The reference's ``model_flops``,
``kernel_model_bytes`` and ``roofline_report`` read dry-run (HLO, mesh)
records and wait for the port's analysis tooling.
"""
from __future__ import annotations

from typing import Any, Dict

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate (no sparsity) at the
# 700 W power limit; operations of every kernel count at this peak.
PEAK_FLOPS = 989e12
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, 80 GB part.
HBM_BW = 3.35e12


def _sparse_side_bytes(Kv: int, S: int, k_max: int, quantized: bool,
                       val_bytes: int = 4) -> int:
    """Device bytes ONE sequence's packed sparse side (k + v) streams
    through the fused kernels: values (``val_bytes`` each, or int8 + f32
    per-vector scale when quantized) and int8 winnow indices, each read
    once."""
    val = k_max * (1 if quantized else val_bytes)
    idx = k_max
    scale = 4 if quantized else 0
    return 2 * Kv * S * (val + idx + scale)


def swan_decode_kernel_bytes(*, B: int, Kv: int, G: int, dh: int, S: int,
                             k_max: int, buffer: int, quantized: bool,
                             val_bytes: int = 4, act_bytes: int = 4) -> int:
    """Ideal per-call device traffic of the SWAN decode kernel (slab or
    paged): packed sparse prefix + dense ring read once (ring, q and o in
    ``act_bytes``), ``buf_pos`` in, o out."""
    sparse = B * _sparse_side_bytes(Kv, S, k_max, quantized, val_bytes)
    ring = 2 * B * Kv * buffer * dh * act_bytes + B * buffer * 4
    q = B * Kv * G * dh * act_bytes
    o = B * Kv * G * dh * act_bytes
    return sparse + ring + q + o


def swan_chunk_kernel_bytes(*, B: int, Kv: int, Q: int, dh: int, S: int,
                            k_max: int, quantized: bool,
                            val_bytes: int = 4) -> int:
    """Ideal per-call device traffic of the chunk-prefill stats kernel: the
    packed sparse prefix once, Q f32 query rows in, (m, l, o_unnorm) f32
    stats out."""
    sparse = B * _sparse_side_bytes(Kv, S, k_max, quantized, val_bytes)
    q = B * Kv * Q * dh * 4
    stats = B * Kv * Q * (2 + dh) * 4
    return sparse + q + stats


def flash_kernel_bytes(*, B: int, H: int, Kv: int, Sq: int, Sk: int, dh: int,
                       dtype_bytes: int = 4) -> int:
    """Ideal per-call device traffic of flash attention: q in and o out for
    H heads, k and v in for Kv heads, each once."""
    qo = 2 * B * H * Sq * dh * dtype_bytes
    kv = 2 * B * Kv * Sk * dh * dtype_bytes
    return qo + kv


def flash_kernel_flops(*, B: int, H: int, Sq: int, Sk: int, dh: int,
                       causal: bool = True) -> float:
    """Operations of flash attention: 2 products of [Sq, dh] x [dh, Sk] per
    head, halved by the causal mask."""
    f = 4.0 * B * H * Sq * Sk * dh
    return f / 2 if causal else f


def swan_prune_kernel_bytes(*, B: int, Kv: int, S: int, dh: int, k_max: int,
                            x_bytes: int = 4, p_bytes: int = 4) -> int:
    """Ideal per-call device traffic of fused winnowing: x and P in, the
    packed values (x's width) and int8 indices out, each once."""
    x = B * Kv * S * dh * x_bytes
    p = Kv * dh * dh * p_bytes
    packed = B * Kv * S * k_max * (x_bytes + 1)
    return x + p + packed


def swan_prune_kernel_flops(*, B: int, Kv: int, S: int, dh: int) -> float:
    """Operations of fused winnowing: the rotation, one [dh] x [dh, dh]
    product per vector (the top-k's compares are not counted)."""
    return 2.0 * B * Kv * S * dh * dh


def roofline_row(name: str, us_per_call: float, hbm_bytes: int,
                 flops: float = 0.0, **tags) -> Dict[str, Any]:
    """One per-kernel roofline row: the floor time from the ideal byte and
    operation model (the larger of bytes / ``HBM_BW`` and operations /
    ``PEAK_FLOPS``) against the measured call time;
    ``achieved_fraction`` = floor / measured."""
    mem_s = hbm_bytes / HBM_BW
    comp_s = flops / PEAK_FLOPS
    bound = "compute" if comp_s > mem_s else "memory"
    floor_s = max(mem_s, comp_s)
    meas_s = us_per_call * 1e-6
    row = {"name": name, "us_per_call": float(us_per_call),
           "hbm_bytes": int(hbm_bytes), "flops": float(flops),
           "bound": bound, "floor_us": floor_s * 1e6,
           "achieved_bw_gbs": (hbm_bytes / meas_s / 1e9) if meas_s else 0.0,
           "achieved_fraction": (floor_s / meas_s) if meas_s else 0.0}
    row.update(tags)
    return row
