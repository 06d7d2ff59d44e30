"""Kernel eligibility (port of ``repro/kernels/dispatch.py:46``).

The reference decides by backend (compiled Pallas on TPU); the port decides
by where the cache lives: a cache on the card goes through the CUDA kernel,
a cache on the CPU through the plain PyTorch path.
"""
from __future__ import annotations

import torch


def decode_kernel_supported(swan, cache_tensor: torch.Tensor) -> bool:
    """The fused decode kernel covers SWAN ``topk`` with a non-empty ring
    and a non-empty sparse slab, for a cache on a CUDA device."""
    return (cache_tensor.is_cuda and swan is not None
            and getattr(swan, "enabled", False) and swan.mode == "topk"
            and swan.buffer > 0 and cache_tensor.shape[2] > 0)
