"""Kernel eligibility (port of ``repro/kernels/dispatch.py:46``).

The reference decides by backend (compiled Pallas on TPU); the port decides
by where the cache lives: a cache on the card goes through the CUDA
kernels, a cache on the CPU through the plain PyTorch path.  One gate
serves the decode and the chunked-prefill reads, slab and paged.
"""
from __future__ import annotations

from typing import Optional

import torch


def kernel_supported(swan, sparse_vals: torch.Tensor,
                     page_tab: Optional[torch.Tensor] = None) -> bool:
    """The SWAN kernels cover ``topk`` with a non-empty ring, for a cache on
    a CUDA device, over a non-empty sparse extent: the slab's rows
    (``sparse_vals [B, Kv, S, k]``) or, paged, the shipped page-table
    prefix (``page_tab [B, Pg]``)."""
    extent = sparse_vals.shape[2] if page_tab is None else page_tab.shape[1]
    return (sparse_vals.is_cuda and swan is not None
            and getattr(swan, "enabled", False) and swan.mode == "topk"
            and swan.buffer > 0 and extent > 0)
