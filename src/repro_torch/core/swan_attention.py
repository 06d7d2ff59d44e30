"""SWAN decode attention over the hybrid cache (paper Algorithm 1, 13-17).

Port of the pure path of ``repro.core.swan_attention``:

  scores = [ q̂ · expand(sparse) ‖ q̂ · buffer ] ;  o = softmax(scores) · V

computed as a gather over q̂ at the packed indices (score side) and a
scatter-add (value side), so no dense [S, dh] tensor is materialised.  This
is the CPU path and the second oracle of the decode kernel
(``repro_torch.kernels.swan_decode``); the serve loop takes the kernel when
the cache lives on the card (``repro_torch.kernels.dispatch``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.hybrid_cache import sparse_len

Params = Dict[str, Any]


def _deq(side: Params) -> torch.Tensor:
    """Packed values ready for the contractions (storage dtype; int8 is
    dequantized to f32, fp8 widened to bf16 as in the reference)."""
    vals = side["vals"]
    if "scale" in side:
        return vals.float() * side["scale"].float()[..., None]
    if vals.dtype == torch.float8_e4m3fn:
        return vals.to(torch.bfloat16)
    return vals


def _sparse_stats(qf: torch.Tensor, k_side: Params, v_side: Params, swan,
                  sp_len: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial softmax statistics over the sparse cache.

      scores[t] = Σ_j k_vals[t,j] · q̂[k_idx[t,j]]            (gather over q̂)
      o[d]      = Σ_t Σ_j (p[t]·v_vals[t,j]) δ[v_idx[t,j]=d]  (scatter-add)

    ``sp_len`` [B] masks each sequence's valid prefix.  Returns
    (m [B,Kv,G], l [B,Kv,G], o_unnorm [B,Kv,G,dh]) with m = 0 on an empty
    prefix."""
    B, Kv, G, dh = qf.shape
    S = k_side["vals"].shape[2]
    k_max = swan.k_max
    scale = 1.0 / math.sqrt(dh)
    trunc = "idx" not in k_side

    kv_ = _deq(k_side)                                 # [B,Kv,S,k]
    vv_ = _deq(v_side)
    if trunc:
        s_sp = torch.einsum("bjgk,bjtk->bjgt",
                            qf[..., :k_max].to(kv_.dtype).float(),
                            kv_.float()) * scale
    else:
        # gather q̂ in the CACHE dtype, contract in f32
        kidx = k_side["idx"].long()[:, :, None].expand(B, Kv, G, S, k_max)
        q_b = qf.to(kv_.dtype)[:, :, :, None, :].expand(B, Kv, G, S, dh)
        q_at = torch.gather(q_b, -1, kidx)             # [B,Kv,G,S,k]
        s_sp = (q_at.float() * kv_.float()[:, :, None]).sum(-1) * scale
    valid = (torch.arange(S, device=qf.device)[None, None, None, :]
             < sp_len[:, None, None, None])
    s_sp = s_sp.masked_fill(~valid, -math.inf)

    m = s_sp.amax(-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s_sp - m_safe[..., None]).masked_fill(~valid, 0.0)
    l = p.sum(-1)

    if trunc:
        o = torch.einsum("bjgt,bjtk->bjgk", p.to(vv_.dtype).float(),
                         vv_.float())
        o = torch.nn.functional.pad(o, (0, dh - k_max))
    else:
        w = p[..., None] * vv_.float()[:, :, None]     # [B,Kv,G,S,k]
        vidx = v_side["idx"].long()[:, :, None].expand(B, Kv, G, S, k_max)
        o = torch.zeros((B, Kv, G, dh), dtype=torch.float32, device=qf.device)
        o.scatter_add_(-1, vidx.reshape(B, Kv, G, S * k_max),
                       w.reshape(B, Kv, G, S * k_max))
    return m_safe, l, o


def swan_decode_attention(q_hat: torch.Tensor, cache: Params, swan,
                          pos: torch.Tensor) -> torch.Tensor:
    """q̂ [B, Kv, G, dh] (rotated, grouped) -> o [B, Kv, G, dh] (rotated).

    Joint exact softmax over [winnowed sparse ‖ dense buffer]; ``pos`` is
    the per-sequence decode position [B]."""
    dh = q_hat.shape[-1]
    qf = q_hat.float()
    sp = sparse_len(swan, pos)                         # [B]
    scale = 1.0 / math.sqrt(dh)
    m_sp, l_sp, o_sp = _sparse_stats(qf, cache["k"], cache["v"], swan, sp)

    if cache["buf_k"].shape[2] == 0:    # bt=0 ablation: sparse-only softmax
        return (o_sp / torch.clamp(l_sp, min=1e-30)[..., None]).to(q_hat.dtype)

    bk, bv = cache["buf_k"], cache["buf_v"]            # [B,Kv,b,dh]
    s_b = torch.einsum("bjgd,bjtd->bjgt", qf.to(bk.dtype).float(),
                       bk.float()) * scale
    b_valid = ((cache["buf_pos"] >= 0)
               & (cache["buf_pos"] <= pos[:, None]))[:, None, None]
    s_b = s_b.masked_fill(~b_valid, -math.inf)
    m_b = s_b.amax(-1)
    m_b = torch.where(torch.isfinite(m_b), m_b, torch.zeros_like(m_b))
    p_b = torch.exp(s_b - m_b[..., None]).masked_fill(~b_valid, 0.0)
    l_b = p_b.sum(-1)
    o_b = torch.einsum("bjgt,bjtd->bjgd", p_b.to(bv.dtype).float(),
                       bv.float())

    m = torch.maximum(m_sp, m_b)
    c_sp = torch.exp(m_sp - m)
    c_b = torch.exp(m_b - m)
    denom = torch.clamp(l_sp * c_sp + l_b * c_b, min=1e-30)
    o = (o_sp * c_sp[..., None] + o_b * c_b[..., None]) / denom[..., None]
    return o.to(q_hat.dtype)
