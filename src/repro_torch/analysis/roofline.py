"""Roofline terms on one NVIDIA H100 SXM (port of
``repro/analysis/roofline.py``).

Per kernel (:66-137 there): a kernel's floor is the larger of its ideal
device-memory bytes over ``HBM_BW`` and its operations over
``PEAK_FLOPS``; ``roofline_row`` puts it beside a measured time.  The
reference models f32 operands throughout; here the value widths are
arguments that default to the reference's f32, so at the defaults every
function gives the reference's number, with two exceptions:
``flash_kernel_bytes`` counts the k/v bytes of every kv head (the
reference counts one, ``roofline.py:107``), and the ``*_flops`` of the
decode, chunk and prune kernels are new (the reference bounds those
kernels by bytes alone; each kernel's ``cost`` gives them to the cost
analyzer, ``analysis.cost``).

Per step (:34-63 and :140 there): ``model_flops`` (6·N·D to train, 2·N·D
to serve, N active for MoE), ``kernel_model_bytes`` (the fused decode
kernel's ideal bytes per device, over ``n_dev`` devices where the
reference divides by its 256-chip pod) and ``roofline_report`` over a
record whose ``step_cost`` holds :class:`~repro_torch.analysis.cost.
StepCosts`' fields (the reference's ``hlo_cost``).  The collective term
uses NVLink's rate; on one card it is 0.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate (no sparsity) at the
# 700 W power limit; operations of every kernel count at this peak.
PEAK_FLOPS = 989e12
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, 80 GB part.
HBM_BW = 3.35e12
# NVIDIA H100 SXM data sheet: fourth-generation NVLink, 900 GB/s per card
# both ways together, so 450 GB/s received (the collective term counts
# received bytes per device, as the reference's per-link ICI rate does).
NVLINK_BW = 450e9

_ADVICE = {
    "compute": ("increase arithmetic efficiency: larger per-card tiles "
                "(less model-axis sharding), fuse elementwise chains, "
                "or drop remat recompute"),
    "memory": ("cut HBM traffic: SWAN-compress the KV cache / quantize "
               "weights / fuse kernels so activations stay in shared "
               "memory and registers"),
    "collective": ("reshard to shrink collectives: move the sharded axis, "
                   "overlap collectives with compute, or compress the wire "
                   "format (int8 gradient sync)"),
}


def model_flops(cfg, shape, n_tokens: Optional[int] = None) -> float:
    """The paper-spec model FLOPs of one step of ``shape``: 6·N·D to train,
    2·N·D to prefill or decode (one new token per sequence), N the active
    parameters.  ``n_tokens`` replaces D where given."""
    n_active = cfg.n_active_params()
    if shape.kind == "decode":
        toks = shape.global_batch
    else:
        toks = shape.global_batch * shape.seq_len
    if n_tokens is not None:
        toks = n_tokens
    return (6.0 if shape.kind == "train" else 2.0) * n_active * toks


def kernel_model_bytes(cfg, shape, swan, n_dev: int = 1) -> int:
    """Per-device bytes the fused SWAN decode kernel streams over one
    decode step of ``shape``: the packed payload + ring + parameters, each
    exactly once, split over ``n_dev`` devices (the reference's 16 x 16
    pod is ``n_dev=256``)."""
    n_attn = sum(1 for i in range(cfg.n_layers) if cfg.layer_kind(i) == "attn")
    B, S = shape.global_batch, shape.seq_len
    per_vec = swan.k_max * (1 if swan.quantize else 2)
    if swan.mode == "topk":
        per_vec += swan.k_max                      # int8 indices
    if swan.quantize:
        per_vec += 4
    sparse = 2 * n_attn * B * cfg.n_kv_heads * S * per_vec
    buf = 2 * n_attn * B * cfg.n_kv_heads * swan.buffer * cfg.d_head * 2
    params = cfg.n_active_params() * 2
    return (sparse + buf + params) // n_dev


def _sparse_side_bytes(Kv: int, S: int, k_max: int, quantized: bool,
                       val_bytes: int = 4) -> int:
    """Device bytes the packed sparse side (k + v) of ``S`` rows per kv
    head streams through the fused kernels: values (``val_bytes`` each,
    or int8 + f32 per-vector scale when quantized) and int8 winnow
    indices, each read once."""
    val = k_max * (1 if quantized else val_bytes)
    idx = k_max
    scale = 4 if quantized else 0
    return 2 * Kv * S * (val + idx + scale)


def swan_decode_kernel_bytes(*, B: int, Kv: int, G: int, dh: int, S: int,
                             k_max: int, buffer: int, quantized: bool,
                             val_bytes: int = 4, act_bytes: int = 4,
                             rows: Optional[int] = None) -> int:
    """Ideal per-call device traffic of the SWAN decode kernel (slab or
    paged): packed sparse prefix + dense ring read once (ring, q and o in
    ``act_bytes``), ``buf_pos`` in, o out.  ``rows``: the packed rows read
    over the whole batch (the kernel stops at each sequence's ``sp_len``);
    B·S by default."""
    rows = B * S if rows is None else rows
    sparse = _sparse_side_bytes(Kv, rows, k_max, quantized, val_bytes)
    ring = 2 * B * Kv * buffer * dh * act_bytes + B * buffer * 4
    q = B * Kv * G * dh * act_bytes
    o = B * Kv * G * dh * act_bytes
    return sparse + ring + q + o


def swan_decode_kernel_flops(*, B: int, Kv: int, G: int, dh: int, S: int,
                             k_max: int, buffer: int,
                             rows: Optional[int] = None) -> float:
    """Operations of one decode call: q·k and p·v over the k stored entries
    of every packed row read (``rows`` over the batch, B·S by default),
    and over the dh columns of every ring slot."""
    rows = B * S if rows is None else rows
    return 4.0 * Kv * G * (rows * k_max + B * buffer * dh)


def swan_chunk_kernel_bytes(*, B: int, Kv: int, Q: int, dh: int, S: int,
                            k_max: int, quantized: bool,
                            val_bytes: int = 4,
                            rows: Optional[int] = None) -> int:
    """Ideal per-call device traffic of the chunk-prefill stats kernel: the
    packed sparse prefix once (``rows`` over the B lanes, the kernel
    stopping at each lane's ``sp_len``; B·S by default), Q f32 query rows
    in, (m, l, o_unnorm) f32 stats out."""
    rows = B * S if rows is None else rows
    sparse = _sparse_side_bytes(Kv, rows, k_max, quantized, val_bytes)
    q = B * Kv * Q * dh * 4
    stats = B * Kv * Q * (2 + dh) * 4
    return sparse + q + stats


def swan_chunk_kernel_flops(*, B: int, Kv: int, Q: int, S: int,
                            k_max: int, rows: Optional[int] = None) -> float:
    """Operations of one chunk-stats call: q·k and p·v over the k stored
    entries of every packed row read (``rows`` over the B lanes, B·S by
    default), for each of the Q query rows."""
    rows = B * S if rows is None else rows
    return 4.0 * Kv * Q * rows * k_max


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


def roofline_report(record: Dict[str, Any], cfg, shape,
                    swan=None) -> Dict[str, Any]:
    """The step's roofline from ``record["step_cost"]`` (flops, hbm_bytes
    and collective_bytes per device) over ``record["n_devices"]``: the
    three terms, the bottleneck, the model FLOPs and their ratio to the
    step's counted flops, the fraction of the ideal time, and for a SWAN
    decode shape the fused kernel's ideal bytes."""
    cost = record["step_cost"]
    n_dev = record["n_devices"]
    compute_s = cost["flops"] / PEAK_FLOPS
    memory_s = cost["hbm_bytes"] / HBM_BW
    collective_s = cost["collective_bytes"] / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    total_flops = cost["flops"] * n_dev
    step_s = max(terms.values())
    ideal_s = mf / (n_dev * PEAK_FLOPS)
    out = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "bottleneck": bottleneck,
        "model_flops": mf,
        "useful_flops_ratio": mf / total_flops if total_flops else 0.0,
        "roofline_fraction": ideal_s / step_s if step_s else 0.0,
        "advice": _ADVICE[bottleneck],
    }
    if swan is not None and shape.kind == "decode":
        kb = kernel_model_bytes(cfg, shape, swan, n_dev)
        out["kernel_model_bytes"] = kb
        out["kernel_model_memory_s"] = kb / HBM_BW
    return out
