"""Hybrid-cache dispatch of the chunk-stats kernels (port of
``repro/kernels/flash_prefill/ops.py:28`` and the kernel calls of
``repro/models/transformer.py:446-480``)."""
from __future__ import annotations

from typing import Any, Dict

import torch

# ``swan_chunk_stats`` is the reference's ``ops.swan_chunk_stats`` (its jit
# wrapper has no counterpart: the port runs eagerly)
from repro_torch.kernels.swan_chunk.swan_chunk import (  # noqa: F401
    Stats, swan_chunk_stats, swan_chunk_stats_paged)

Params = Dict[str, Any]


def _q_bulk(q_hat: torch.Tensor) -> torch.Tensor:
    """[P, S, Kv, G, dh] chunk queries -> the query-flattened f32 layout
    [P, Kv, S·G, dh] the kernels take."""
    P, S, Kv, G, dh = q_hat.shape
    return q_hat.float().permute(0, 2, 1, 3, 4).reshape(P, Kv, S * G, dh) \
        .contiguous()


def chunk_stats_from_view(q_hat: torch.Tensor, view: Params,
                          sp_len: torch.Tensor) -> Stats:
    """Stats over the lanes' slab rows (``view["k"]``/``["v"]`` [P,Kv,S,k])."""
    k, v = view["k"], view["v"]
    c = lambda x: None if x is None else x.contiguous()  # noqa: E731
    return swan_chunk_stats(_q_bulk(q_hat), c(k["vals"]), c(k["idx"]),
                            c(v["vals"]), c(v["idx"]), sp_len.int(),
                            k_scale=c(k.get("scale")), v_scale=c(v.get("scale")))


def chunk_stats_from_pool(q_hat: torch.Tensor, pool: Params,
                          sp_len: torch.Tensor,
                          page_rows: torch.Tensor) -> Stats:
    """Stats over the page pool (one layer's ``pool`` dict) through the
    lanes' page-table rows: no logical view is materialised."""
    pk, pv = pool["k"], pool["v"]
    return swan_chunk_stats_paged(
        _q_bulk(q_hat), pk["vals"], pk["idx"], pv["vals"], pv["idx"],
        sp_len.int(), page_rows.contiguous(), pool_k_scale=pk.get("scale"),
        pool_v_scale=pv.get("scale"))
