"""Grouped-query attention with RoPE and the dense KV cache (baseline).

Port of ``repro.models.attention``: projections, plain and blocked
(online-softmax) attention, causal for prefill and non-causal for an
encoder or a cross-attention (``attn_forward``), and single-token decode
against a dense cache.  SWAN decode lives in
``repro_torch.core.swan_attention``.

Parameter layout (per layer):
  wq: [d, H*dh]   wk: [d, Kv*dh]   wv: [d, Kv*dh]   wo: [H*dh, d]
  (+ bq: [H*dh], bk/bv: [Kv*dh] with ``cfg.qkv_bias``; bo: [d] with
  ``cfg.attn_out_bias``)
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.hybrid_cache import LaneWrites, apply_lane_writes_
from repro_torch.models.common import apply_rope, torch_dtype

Params = Dict[str, Any]

DENSE_ATTN_MAX_SEQ = 2048     # above this, use blocked attention
ATTN_BLOCK = 512              # kv block for blocked attention


def project_qkv(p: Params, cfg, x: torch.Tensor,
                positions: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> q [B, S, H, dh], k/v [B, S, Kv, dh]; the biases
    (when the params hold them) are added before RoPE, which applies when
    ``cfg.pos`` is "rope" and ``positions`` are given."""
    B, S, _ = x.shape
    H, Kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k = q.reshape(B, S, H, dh), k.reshape(B, S, Kv, dh)
    if cfg.pos == "rope" and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, Kv, dh)


def output_proj(p: Params, o: torch.Tensor) -> torch.Tensor:
    """o: [B, S, H, dh] -> [B, S, d] (plus ``bo`` where the params hold
    it)."""
    B, S = o.shape[:2]
    y = o.reshape(B, S, -1) @ p["wo"]
    return y + p["bo"] if "bo" in p else y


def _expand_kv(k: torch.Tensor, group: int) -> torch.Tensor:
    """[B, S, Kv, dh] -> [B, S, Kv*G, dh] by repeating each kv head G times."""
    if group == 1:
        return k
    B, S, Kv, dh = k.shape
    return k[:, :, :, None, :].expand(B, S, Kv, group, dh).reshape(
        B, S, Kv * group, dh)


def _query_positions(Sq: int, q_offset, device) -> torch.Tensor:
    """Absolute query positions [B|1, Sq]: ``q_offset`` is a scalar or
    per-sequence [B] (each lane's chunk resumes at its own position)."""
    ar = torch.arange(Sq, device=device)[None]
    if isinstance(q_offset, torch.Tensor):
        return ar + q_offset.to(device).reshape(-1, 1)
    return ar + int(q_offset)       # an int never becomes a device tensor


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, q_offset=0) -> torch.Tensor:
    """Plain softmax attention.  q: [B,Sq,H,dh], k/v: [B,Sk,Kv,dh];
    ``q_offset`` (scalar or [B]) shifts the causal mask."""
    B, Sq, H, dh = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    k = _expand_kv(k, H // Kv)
    v = _expand_kv(v, H // Kv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(dh)
    if causal:
        qp = _query_positions(Sq, q_offset, q.device)[:, :, None]  # [B|1,Sq,1]
        kp = torch.arange(Sk, device=q.device)[None, None, :]
        scores = scores.masked_fill(~(kp <= qp)[:, None],
                                    torch.finfo(torch.float32).min)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, q_offset=0,
                      block: int = ATTN_BLOCK) -> torch.Tensor:
    """Online-softmax attention over KV blocks, O(Sq·block) memory;
    ``q_offset`` as in ``dense_attention``."""
    B, Sq, H, dh = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    k = _expand_kv(k, H // Kv)
    v = _expand_kv(v, H // Kv)
    scale = 1.0 / math.sqrt(dh)
    qf = q.float()
    q_pos = _query_positions(Sq, q_offset, q.device)            # [B|1, Sq]
    m = torch.full((B, H, Sq), -math.inf, device=q.device)
    l = torch.zeros((B, H, Sq), device=q.device)
    acc = torch.zeros((B, H, Sq, dh), device=q.device)
    for start in range(0, Sk, block):
        kblk = k[:, start:start + block].float()
        vblk = v[:, start:start + block].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kblk) * scale
        k_pos = start + torch.arange(kblk.shape[1], device=q.device)
        valid = torch.ones((1, Sq, k_pos.shape[0]), dtype=torch.bool,
                           device=q.device)
        if causal:
            valid = k_pos[None, None, :] <= q_pos[:, :, None]  # [B|1,Sq,blk]
        valid = valid[:, None]
        s = s.masked_fill(~valid, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        p = torch.exp(s - m_safe[..., None]).masked_fill(~valid, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                           torch.zeros_like(m))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vblk)
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 2, 1, 3).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> torch.Tensor:
    """Full attention, dense up to DENSE_ATTN_MAX_SEQ queries and keys,
    blocked above (the reference's split: ``attention.py:201-204``)."""
    if max(q.shape[1], k.shape[1]) > DENSE_ATTN_MAX_SEQ:
        return blocked_attention(q, k, v, causal=causal)
    return dense_attention(q, k, v, causal=causal)


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Prefill attention (the reference's ``transformer.py:317-320``)."""
    return attention(q, k, v, causal=True)


def cross_kv(p: Params, cfg, kv_x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keys and values [B, Sk, Kv, dh] of a cross-attention from the
    encoder's stream ``kv_x`` [B, Sk, d] (biases added, no RoPE)."""
    B, Sk, _ = kv_x.shape
    k, v = kv_x @ p["wk"], kv_x @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return (k.reshape(B, Sk, cfg.n_kv_heads, cfg.d_head),
            v.reshape(B, Sk, cfg.n_kv_heads, cfg.d_head))


def attn_forward(p: Params, cfg, x: torch.Tensor,
                 positions: Optional[torch.Tensor] = None,
                 causal: bool = True,
                 kv_x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full attention of x [B, S, d] (the reference's ``attn_forward``):
    self-attention, causal or not (an encoder's), or with ``kv_x`` a
    non-causal cross-attention over its keys and values."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q, k, v = project_qkv(p, cfg, x, positions)
    if kv_x is not None:
        k, v = cross_kv(p, cfg, kv_x)
        causal = False
    return output_proj(p, attention(q, k, v, causal))


# ---------------------------------------------------------------------------
# Dense KV cache (baseline decode path)
# ---------------------------------------------------------------------------

def init_dense_cache(cfg, batch: int, max_seq: int, device,
                     lead: Tuple[int, ...] = ()) -> Params:
    """Cache layout [B, Kv, S, dh] (``lead`` prepends e.g. the [L] axis)."""
    shape = (*lead, batch, cfg.n_kv_heads, max_seq, cfg.d_head)
    dt = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def dense_cache_insert_(cache: Params, k: torch.Tensor, v: torch.Tensor,
                        pos: int) -> Params:
    """Insert [B, S_new, Kv, dh] at position ``pos`` (python int), in place."""
    S = k.shape[1]
    cache["k"][:, :, pos:pos + S] = k.transpose(1, 2)
    cache["v"][:, :, pos:pos + S] = v.transpose(1, 2)
    return cache


def dense_cache_insert_rows_(cache: Params, k: torch.Tensor,
                             v: torch.Tensor, plan: LaneWrites) -> Params:
    """Insert chunk K/V [P, S, Kv, dh] by the dispatch's row ``plan``
    (``hybrid_cache.lane_writes``: dead lanes and rows past max_seq are
    dropped), in place (the batched chunked-prefill insert)."""
    apply_lane_writes_(cache["k"], k, plan)
    apply_lane_writes_(cache["v"], v, plan)
    return cache


def dense_cache_insert_decode_(cache: Params, k: torch.Tensor,
                               v: torch.Tensor, pos_b: torch.Tensor) -> Params:
    """Insert one token per sequence ([B, 1, Kv, dh]) at positions ``pos_b``
    [B], in place.  Dead lanes (pos < 0) keep their rows: they rewrite the
    row they would clobber with its own content."""
    bi = torch.arange(pos_b.shape[0], device=pos_b.device)
    dead = pos_b < 0
    row = torch.where(dead, torch.zeros_like(pos_b), pos_b).long()
    for name, new in (("k", k), ("v", v)):
        cur = cache[name][bi, :, row]                            # [B, Kv, dh]
        cache[name][bi, :, row] = torch.where(
            dead[:, None, None], cur, new[:, 0].to(cur.dtype))
    return cache


def attn_decode_dense(p: Params, cfg, x: torch.Tensor, pos: torch.Tensor,
                      cache: Params) -> Tuple[torch.Tensor, Params]:
    """One-token decode with the dense cache (updated in place).
    x: [B, 1, d]; pos: [B] int32."""
    B = x.shape[0]
    H, Kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = project_qkv(p, cfg, x, pos[:, None])
    dense_cache_insert_decode_(cache, k, v, pos)
    kc, vc = cache["k"], cache["v"]                  # [B,Kv,S,dh] storage dtype
    S = kc.shape[2]
    qh = q.reshape(B, Kv, H // Kv, dh)
    # f32 contraction of the storage-dtype operands (the reference's
    # preferred_element_type=f32)
    scores = torch.einsum("bngd,bnsd->bngs", qh.to(kc.dtype).float(),
                          kc.float()) / math.sqrt(dh)
    valid = (torch.arange(S, device=x.device)[None, None, None, :]
             <= pos[:, None, None, None])
    scores = scores.masked_fill(~valid, torch.finfo(torch.float32).min)
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bngs,bnsd->bngd", w.to(vc.dtype).float(), vc.float())
    o = o.reshape(B, 1, H, dh).to(x.dtype)
    return output_proj(p, o), cache
