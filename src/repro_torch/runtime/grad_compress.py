"""Gradient compression (port of ``repro.runtime.grad_compress``).

``compress_gradients`` applies a quantize/dequantize round (symmetric
int8, one scale per 4096-wide chunk, round half to even) to the gradients
before the optimizer; with ``error_feedback`` the previous residuals are
added first.  ``residuals`` gives each leaf's quantization residual.  The
reference's ``dp_int8_allreduce`` (int8 on the wire across a data-parallel
mesh axis) waits for the port's meshes.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.tree import tree_map

Tree = Any
CHUNK = 4096


def _quantize_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-CHUNK symmetric int8.  Returns (q int8 [n_chunks, CHUNK], scale
    [n_chunks, 1])."""
    flat = g.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % CHUNK)).reshape(-1, CHUNK)
    scale = torch.clamp(flat.abs().amax(dim=1, keepdim=True),
                        min=1e-12) / 127.0
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_leaf(q: torch.Tensor, scale: torch.Tensor, shape,
                     dtype) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def quantize_tree(grads: Tree) -> Tree:
    return tree_map(_quantize_leaf, grads)


def compress_gradients(grads: Tree, error_feedback: Tree = None) -> Tree:
    """Quant→dequant round (lossy); with ``error_feedback`` (a tree of f32
    residuals) the residuals are added before quantization."""
    def one(g, e=None):
        g32 = g.float()
        if e is not None:
            g32 = g32 + e
        q, s = _quantize_leaf(g32)
        return _dequantize_leaf(q, s, g.shape, torch.float32).to(g.dtype)

    if error_feedback is None:
        return tree_map(one, grads)
    return tree_map(one, grads, error_feedback)


def residuals(grads: Tree) -> Tree:
    """Quantization residual per leaf (for error-feedback accumulation)."""
    def one(g):
        g32 = g.float()
        q, s = _quantize_leaf(g32)
        return g32 - _dequantize_leaf(q, s, g.shape, torch.float32)
    return tree_map(one, grads)
