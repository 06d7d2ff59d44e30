"""Hybrid-cache dispatch of the swan_decode kernels (port of
``repro/kernels/swan_decode/ops.py:34``, ``:50``, ``:67`` and ``:75``)."""
from __future__ import annotations

from typing import Any, Dict, Union

import torch

from repro_torch.core.hybrid_cache import per_seq_pos, sparse_len
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


def swan_decode_attention_kernel(q_hat: torch.Tensor, cache: Params, swan,
                                 pos: Union[int, torch.Tensor]
                                 ) -> torch.Tensor:
    """The slab kernel on one layer's hybrid cache (port of
    ``repro/kernels/swan_decode/ops.py:67``); ``pos`` a scalar or [B].  The
    reference's ``cfg`` and ``block_s`` have no counterpart: the port runs
    eagerly and the CUDA tile is the kernel's own."""
    return swan_decode_from_cache(q_hat, cache, swan,
                                  per_seq_pos(pos, q_hat.shape[0],
                                              q_hat.device))


def swan_decode_attention_kernel_paged(q_hat: torch.Tensor, cache: Params,
                                       swan, pos: Union[int, torch.Tensor],
                                       page_tab: torch.Tensor
                                       ) -> torch.Tensor:
    """The paged kernel on one layer's page pool and rings (port of
    ``repro/kernels/swan_decode/ops.py:75``); ``pos`` a scalar or [B]."""
    return swan_decode_paged_from_cache(q_hat, cache, swan,
                                        per_seq_pos(pos, q_hat.shape[0],
                                                    q_hat.device), page_tab)
