"""Plain PyTorch version of fused winnowing (port of
``repro/kernels/swan_prune/ref.py:8``): rotate, magnitude top-k, pack.

The rotation runs in f32 (TF32 off); the top-k is a stable descending
sort on |x̂|, so ties go to the lowest index, as ``lax.top_k`` and the TPU
kernel's arg-max loop (``swan_prune.py:40-42``) break them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.device import f32_matmul


def swan_prune_reference(x: torch.Tensor, p_rot: torch.Tensor, k_max: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,Kv,S,dh], p_rot [Kv,dh,dh] -> (vals [B,Kv,S,k_max] x.dtype,
    idx [B,Kv,S,k_max] int8), in descending |x̂| order."""
    with f32_matmul():
        xh = torch.einsum("bjsd,jde->bjse", x.float(), p_rot.float())
    idx = torch.sort(-xh.abs(), dim=-1, stable=True).indices[..., :k_max]
    vals = torch.gather(xh, -1, idx)
    return vals.to(x.dtype), idx.to(torch.int8)
