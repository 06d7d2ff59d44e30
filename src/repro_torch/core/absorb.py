"""SWAN weight absorption (§4.2): fold P_VO into W_V / W_O offline.

Port of ``repro.core.absorb``.  Values come out in the rotated space
(Ŵ_V = W_V · P_VO per KV head) and the output projection undoes the
rotation (Ŵ_O^(j) = P_VOᵀ · W_O^(j) per query head): exactly lossless
(Lemma A.2).  Accepts one layer's attention params or stacked [L, ...].
"""
from __future__ import annotations

from typing import Any, Dict

import torch

Params = Dict[str, Any]


def _absorb_wv(wv: torch.Tensor, p_vo: torch.Tensor, n_kv: int,
               d_head: int) -> torch.Tensor:
    """wv [..., d, Kv·dh] x p_vo [..., Kv, dh, dh] -> Ŵ_V [..., d, Kv·dh]."""
    *lead, d, _ = wv.shape
    w = wv.reshape(*lead, d, n_kv, d_head).float()
    w = torch.einsum("...dje,...jef->...djf", w, p_vo.float())
    return w.reshape(*lead, d, n_kv * d_head).to(wv.dtype)


def _absorb_bv(bv: torch.Tensor, p_vo: torch.Tensor, n_kv: int,
               d_head: int) -> torch.Tensor:
    *lead, _ = bv.shape
    b = bv.reshape(*lead, n_kv, d_head).float()
    b = torch.einsum("...je,...jef->...jf", b, p_vo.float())
    return b.reshape(*lead, n_kv * d_head).to(bv.dtype)


def _absorb_wo(wo: torch.Tensor, p_vo: torch.Tensor, n_heads: int,
               n_kv: int, d_head: int) -> torch.Tensor:
    """wo [..., H·dh, d]: each head slice gets P_VOᵀ premultiplied, with
    P_VO repeated for every query head of its KV group."""
    *lead, _, d = wo.shape
    G = n_heads // n_kv
    w = wo.reshape(*lead, n_kv, G, d_head, d).float()
    w = torch.einsum("...jef,...jged->...jgfd", p_vo.float(), w)
    return w.reshape(*lead, n_heads * d_head, d).to(wo.dtype)


def absorb_vo(attn_params: Params, p_vo: torch.Tensor, n_heads: int,
              n_kv: int, d_head: int) -> Params:
    """Attention params with Ŵ_V / Ŵ_O (and b̂_v); new tensors, the input
    dict is left as it was."""
    out = dict(attn_params)
    out["wv"] = _absorb_wv(attn_params["wv"], p_vo, n_kv, d_head)
    out["wo"] = _absorb_wo(attn_params["wo"], p_vo, n_heads, n_kv, d_head)
    if "bv" in attn_params:
        out["bv"] = _absorb_bv(attn_params["bv"], p_vo, n_kv, d_head)
    return out
