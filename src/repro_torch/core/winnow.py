"""SWAN winnowing: runtime rotation, magnitude pruning, packing, quantization.

Port of ``repro.core.winnow``.  ``topk`` keeps the k_max largest-|x| dims
per vector as (values, int8 indices); ``truncate`` keeps the first k_max
rotated dims.  ``k_active <= k_max`` zeroes the packed tail.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

Params = Dict[str, Any]
KActive = Optional[Union[int, torch.Tensor]]

# float8_e4m3fn's largest finite value is 448; round-to-nearest-even sends
# anything above 464 to the NaN encoding.  The reference (ml_dtypes) casts
# so, torch's cast saturates to ±448 instead — this threshold restores the
# reference's behaviour.
_FP8_E4M3_OVERFLOW = 464.0


# ---------------------------------------------------------------------------
# Runtime rotation (P_QK — cannot be absorbed because of RoPE)
# ---------------------------------------------------------------------------

def rotate_q(q: torch.Tensor, p_qk: torch.Tensor, n_kv: int) -> torch.Tensor:
    """q [B, S, H, dh] x p_qk [Kv, dh, dh] -> q̂ [B, S, Kv, G, dh]."""
    B, S, H, dh = q.shape
    qg = q.reshape(B, S, n_kv, H // n_kv, dh)
    return torch.einsum("bsjgd,jde->bsjge", qg, p_qk.to(q.dtype))


def rotate_k(k: torch.Tensor, p_qk: torch.Tensor) -> torch.Tensor:
    """k [B, S, Kv, dh] x p_qk [Kv, dh, dh] -> k̂ [B, S, Kv, dh]."""
    return torch.einsum("bsjd,jde->bsje", k, p_qk.to(k.dtype))


# ---------------------------------------------------------------------------
# Pruning / packing
# ---------------------------------------------------------------------------

def _live_mask(k_active, k_max: int, out_ndim: int, device) -> torch.Tensor:
    """Broadcastable ``col < k_active`` mask; a tensor ``k_active`` aligns
    with the leading axes of the packed [..., k_max] tensor.  A python int
    never becomes a device tensor (that copy would synchronise the host
    with the card at every winnow)."""
    if isinstance(k_active, int):
        return torch.arange(k_max, device=device) < k_active
    k_active = torch.as_tensor(k_active, device=device)
    live = torch.arange(k_max, device=device) < k_active[..., None]
    return live.reshape(tuple(k_active.shape)
                        + (1,) * (out_ndim - 1 - k_active.ndim) + (k_max,))


def topk_pack(x: torch.Tensor, k_max: int, k_active: KActive = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vector magnitude top-k: [..., dh] -> (vals [..., k_max] x.dtype,
    idx [..., k_max] int8).  A stable sort on −|x|, so ties go to the
    lowest index exactly as in the reference (``torch.topk`` promises no
    tie order)."""
    dh = x.shape[-1]
    if k_max > dh:
        raise ValueError(f"k_max={k_max} > d_head={dh}")
    mag = torch.abs(x.float())
    idx = torch.sort(-mag, dim=-1, stable=True).indices[..., :k_max]
    vals = torch.gather(x, -1, idx)
    if k_active is not None:
        vals = torch.where(_live_mask(k_active, k_max, vals.ndim, x.device),
                           vals, torch.zeros_like(vals))
    return vals, idx.to(torch.int8)


def truncate_pack(x: torch.Tensor, k_max: int,
                  k_active: KActive = None) -> torch.Tensor:
    """Keep the leading k_max rotated dims: [..., dh] -> [..., k_max]."""
    vals = x[..., :k_max]
    if k_active is not None:
        vals = torch.where(_live_mask(k_active, k_max, vals.ndim, x.device),
                           vals, torch.zeros_like(vals))
    return vals


def unpack_dense(vals: torch.Tensor, idx: Optional[torch.Tensor],
                 dh: int) -> torch.Tensor:
    """Expand packed vectors [..., k] -> dense [..., dh] in ``vals``' dtype
    (truncate mode, ``idx`` None, pads).  Used by the oracle and the
    chunked-prefill bulk read only; the cache itself stays packed."""
    if idx is None:
        return torch.nn.functional.pad(vals, (0, dh - vals.shape[-1]))
    dense = torch.zeros((*vals.shape[:-1], dh), dtype=vals.dtype,
                        device=vals.device)
    return dense.scatter_(-1, idx.long(), vals)


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------

def quantize_int8(vals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., k] -> (int8 [..., k], scale f32 [...]); symmetric, per vector."""
    v = vals.float()
    scale = torch.clamp(torch.amax(torch.abs(v), dim=-1), min=1e-12) / 127.0
    q = torch.clamp(torch.round(v / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def cast_fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """The paper's literal 8-bit float: a direct e4m3fn cast, no scale."""
    x = x.float()
    x = torch.where(torch.abs(x) > _FP8_E4M3_OVERFLOW,
                    torch.full_like(x, float("nan")).copysign(x), x)
    return x.to(torch.float8_e4m3fn)


# ---------------------------------------------------------------------------
# Combined winnow step used by the hybrid cache
# ---------------------------------------------------------------------------

def winnow_vector(x: torch.Tensor, swan, which: str,
                  k_act: KActive = None) -> Params:
    """Winnow rotated vectors x [..., dh] per the SwanConfig.

    which: 'k' or 'v' (separate runtime retention knobs).  ``k_act``
    overrides the runtime retention (the serve path passes the per-layer
    value for both sides, as the reference does).  Returns a dict with
    'vals' (+ 'idx' for topk, + 'scale' for int8)."""
    if k_act is None:
        k_active = swan.kk if which == "k" else swan.kv
        k_act = None if k_active == swan.k_max else k_active
    if swan.mode == "topk":
        vals, idx = topk_pack(x, swan.k_max, k_act)
        out: Params = {"vals": vals, "idx": idx}
    else:
        out = {"vals": truncate_pack(x, swan.k_max, k_act)}
    if swan.quantize:
        if swan.quant_dtype == "fp8":
            out["vals"] = cast_fp8_e4m3(out["vals"])
        else:
            out["vals"], out["scale"] = quantize_int8(out["vals"])
    return out
