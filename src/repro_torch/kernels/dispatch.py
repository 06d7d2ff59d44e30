"""Kernel eligibility (port of ``repro/kernels/dispatch.py:46``).

The reference decides by backend (compiled Pallas on TPU); the port decides
by where the cache lives: a cache on the card goes through the CUDA
kernels, a cache on the CPU through the plain PyTorch path.  One gate
serves the decode and the chunked-prefill reads, slab and paged;
:func:`plain_reads` closes it for the code it wraps (the serve auditor's
plain-path engines on the card).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional

import torch

_PLAIN = contextvars.ContextVar("repro_torch_plain_reads", default=False)


@contextlib.contextmanager
def plain_reads() -> Iterator[None]:
    """While active (in this thread's context), :func:`kernel_supported`
    answers no for every cache: models and engines built or run inside
    read SWAN through the plain PyTorch path even on the card."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def kernel_supported(swan, sparse_vals: torch.Tensor,
                     page_tab: Optional[torch.Tensor] = None) -> bool:
    """The SWAN kernels cover ``topk`` with a non-empty ring, for a cache on
    a CUDA device, over a non-empty sparse extent: the slab's rows
    (``sparse_vals [B, Kv, S, k]``) or, paged, the shipped page-table
    prefix (``page_tab [B, Pg]``); never inside :func:`plain_reads`."""
    extent = sparse_vals.shape[2] if page_tab is None else page_tab.shape[1]
    return (not _PLAIN.get() and sparse_vals.is_cuda and swan is not None
            and getattr(swan, "enabled", False) and swan.mode == "topk"
            and swan.buffer > 0 and extent > 0)
