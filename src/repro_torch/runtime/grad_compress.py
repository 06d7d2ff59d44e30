"""Gradient compression (port of ``repro.runtime.grad_compress``).

``compress_gradients`` applies a quantize/dequantize round (symmetric
int8, one scale per 4096-wide chunk, round half to even) to the gradients
before the optimizer; with ``error_feedback`` the previous residuals are
added first.  ``residuals`` gives each leaf's quantization residual.
``dp_int8_allreduce`` mean-reduces gradients across a data-parallel axis
of a ``DeviceMesh`` with int8 on the wire: each rank quantises, all-gathers
the int8 values and the f32 scales, and dequantises and averages locally
(gloo on the CPU, NCCL on the card, or the dry-run's fake group).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist
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


# ---------------------------------------------------------------------------
# Explicit int8-on-the-wire DP all-reduce
# ---------------------------------------------------------------------------

def dp_int8_allreduce(grads: Tree, axis_name: str, mesh) -> Tree:
    """Mean-reduce gradients across ``mesh``'s ``axis_name`` with int8 on
    the wire: quantise locally (``_quantize_leaf``), all-gather the int8
    values and the f32 scales over that axis's process group, dequantise
    and average locally.  4x less gradient traffic than an f32 all-reduce
    at the cost of one quantisation round per step.  ``mesh`` is a
    ``torch.distributed`` ``DeviceMesh``, or a ``launch.mesh.Mesh`` that
    carries one (``device_mesh``)."""
    dm = getattr(mesh, "device_mesh", None) or mesh
    group = dm.get_group(axis_name)
    n_ranks = dist.get_world_size(group)

    def gather(t: torch.Tensor) -> torch.Tensor:
        out = [torch.empty_like(t) for _ in range(n_ranks)]
        dist.all_gather(out, t.contiguous(), group=group)
        return torch.stack(out)                      # [P, n_chunks, ...]

    def one(g):
        q, s = _quantize_leaf(g)
        deq = gather(q).float() * gather(s)          # [P, n_chunks, CHUNK]
        mean = deq.mean(dim=0)
        return mean.reshape(-1)[:g.numel()].reshape(g.shape).to(g.dtype)
    return tree_map(one, grads)
