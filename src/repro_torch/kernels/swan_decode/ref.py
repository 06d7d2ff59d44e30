"""Plain PyTorch oracle of the swan_decode kernel: full decompression of the
packed cache and an exact softmax over [sparse ‖ buffer], in f32.

Port of ``repro/kernels/swan_decode/ref.py``.  It is the kernel's plain
twin: the wrapper runs it for CPU tensors, and the tests and
``chip_smoke.py`` hold the kernel against it.  It never runs on the serve
path when a card is present.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def _dense(vals: torch.Tensor, idx: torch.Tensor,
           scale: Optional[torch.Tensor], dh: int) -> torch.Tensor:
    v = vals.float()
    if scale is not None:
        v = v * scale.float()[..., None]
    out = torch.zeros((*v.shape[:-1], dh), dtype=torch.float32,
                      device=v.device)
    return out.scatter_(-1, idx.long(), v)


def swan_decode_reference(q, k_vals, k_idx, v_vals, v_idx, buf_k, buf_v,
                          buf_pos, pos, sp_len, k_scale=None, v_scale=None
                          ) -> torch.Tensor:
    """q [B,Kv,G,dh]; packed sparse [B,Kv,S,k]; buffer [B,Kv,b,dh];
    buf_pos [B,b]; ``pos``/``sp_len`` int32 [B].  Returns o [B,Kv,G,dh] in
    q's dtype."""
    B, Kv, G, dh = q.shape
    S = k_vals.shape[2]
    kd = _dense(k_vals, k_idx, k_scale, dh)                    # [B,Kv,S,dh]
    vd = _dense(v_vals, v_idx, v_scale, dh)
    qf = q.float()
    s_sp = torch.einsum("bjgd,bjtd->bjgt", qf, kd) / math.sqrt(dh)
    sp_ok = (torch.arange(S, device=q.device)[None, :]
             < sp_len[:, None])                                # [B, S]
    s_sp = s_sp.masked_fill(~sp_ok[:, None, None, :], -math.inf)

    s_b = torch.einsum("bjgd,bjtd->bjgt", qf, buf_k.float()) / math.sqrt(dh)
    b_ok = (buf_pos >= 0) & (buf_pos <= pos[:, None])           # [B, b]
    s_b = s_b.masked_fill(~b_ok[:, None, None, :], -math.inf)

    w = torch.softmax(torch.cat([s_sp, s_b], dim=-1), dim=-1)
    v_all = torch.cat([vd, buf_v.float()], dim=2)
    return torch.einsum("bjgt,bjtd->bjgd", w, v_all).to(q.dtype)
