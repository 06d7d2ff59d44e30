"""Hybrid-cache dispatch of the swan_decode kernels (port of
``repro/kernels/swan_decode/ops.py:34`` and ``:50``)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.hybrid_cache import sparse_len
from repro_torch.kernels.swan_decode.swan_decode import (swan_decode,
                                                         swan_decode_paged)

Params = Dict[str, Any]


def _require_topk(swan) -> None:
    if swan.mode != "topk":
        raise NotImplementedError("the kernel covers the paper-faithful "
                                  "'topk' mode")


def swan_decode_from_cache(q_hat: torch.Tensor, cache: Params, swan,
                           pos: torch.Tensor) -> torch.Tensor:
    """Unpack one layer's slab hybrid cache into kernel operands.
    ``pos`` [B]."""
    _require_topk(swan)
    return swan_decode(
        q_hat.contiguous(), cache["k"]["vals"], cache["k"]["idx"],
        cache["v"]["vals"], cache["v"]["idx"], cache["buf_k"], cache["buf_v"],
        cache["buf_pos"], pos, sparse_len(swan, pos),
        k_scale=cache["k"].get("scale"), v_scale=cache["v"].get("scale"))


def swan_decode_paged_from_cache(q_hat: torch.Tensor, cache: Params, swan,
                                 pos: torch.Tensor,
                                 page_tab: torch.Tensor) -> torch.Tensor:
    """One layer's page pool and rings plus the page-table prefix straight
    into the paged kernel: ``paged_logical_view`` never runs."""
    _require_topk(swan)
    pk, pv = cache["pool"]["k"], cache["pool"]["v"]
    return swan_decode_paged(
        q_hat.contiguous(), pk["vals"], pk["idx"], pv["vals"], pv["idx"],
        cache["buf_k"], cache["buf_v"], cache["buf_pos"], pos,
        sparse_len(swan, pos), page_tab.contiguous(),
        pool_k_scale=pk.get("scale"), pool_v_scale=pv.get("scale"))
