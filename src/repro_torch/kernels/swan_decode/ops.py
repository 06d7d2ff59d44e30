"""Hybrid-cache dispatch of the swan_decode kernel (port of
``repro/kernels/swan_decode/ops.py:34``)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.hybrid_cache import sparse_len
from repro_torch.kernels.swan_decode.swan_decode import swan_decode

Params = Dict[str, Any]


def swan_decode_from_cache(q_hat: torch.Tensor, cache: Params, swan,
                           pos: torch.Tensor) -> torch.Tensor:
    """Unpack one layer's hybrid cache into kernel operands.  ``pos`` [B]."""
    if swan.mode != "topk":
        raise NotImplementedError("the kernel covers the paper-faithful "
                                  "'topk' mode")
    return swan_decode(
        q_hat.contiguous(), cache["k"]["vals"], cache["k"]["idx"],
        cache["v"]["vals"], cache["v"]["idx"], cache["buf_k"], cache["buf_v"],
        cache["buf_pos"], pos, sparse_len(swan, pos),
        k_scale=cache["k"].get("scale"), v_scale=cache["v"].get("scale"))
