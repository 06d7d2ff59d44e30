"""Plain PyTorch versions of GQA flash attention (port of
``repro/kernels/flash_prefill/ref.py:10``).

The reference has two causal masks: its oracle keeps key ``t`` for query
``i`` when ``t <= i + (Sk - Sq)`` (bottom-right aligned, ``ref.py:19``),
its TPU kernel when ``t <= i`` (top-left, ``flash_prefill.py:90-94``).
They agree only at Sq == Sk.  Here the offset is explicit:
``flash_attention_reference`` keeps the oracle's mask by default, and
``flash_attention_plain`` — the twin the CUDA kernel is held to — is the
same function at ``q_offset = 0``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.device import f32_matmul


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              q_offset: Optional[int] = None) -> torch.Tensor:
    """q [B,Sq,H,dh]; k/v [B,Sk,Kv,dh] -> o [B,Sq,H,dh] in q's dtype.
    Scores, softmax and the value sum in f32.  Causal: query ``i`` sees keys
    ``t <= i + q_offset`` (default ``Sk - Sq``, the oracle's mask)."""
    B, Sq, H, dh = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    ke = k.float().repeat_interleave(G, dim=2)
    ve = v.float().repeat_interleave(G, dim=2)
    with f32_matmul():
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), ke) / math.sqrt(dh)
        if causal:
            off = Sk - Sq if q_offset is None else q_offset
            mask = torch.ones((Sq, Sk), dtype=torch.bool,
                              device=q.device).tril(diagonal=off)
            s = s.masked_fill(~mask, -math.inf)
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", w, ve)
    return o.to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """The CUDA kernel's twin: the TPU kernel's top-left mask (key ``t``
    visible to query ``i`` iff ``t <= i``)."""
    return flash_attention_reference(q, k, v, causal, q_offset=0)
