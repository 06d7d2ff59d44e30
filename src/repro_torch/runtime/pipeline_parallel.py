"""GPipe-style pipeline parallelism (port of
``repro.runtime.pipeline_parallel``).

The layer stack is split into P contiguous stages along a ``pipe`` mesh
axis; microbatches stream through with the classic (M + P - 1)-tick
schedule: stage 0 injects microbatch t at tick t, every stage applies its
layers to what it holds, the last stage collects a finished microbatch
from tick P - 1 on, and the stage outputs shift one stage on (a
collective-permute, zeros into stage 0).  Autograd gives the backward
(the shift's transpose is the reverse shift), as jax's autodiff does for
the reference's ``ppermute``.

The mesh follows the sharded serve engine's convention: a
``launch.mesh.Mesh`` laid over ONE device (``devices=[dev] * P``).  The
stage axis is the leading axis of stage-major tensors: the parameters
``[P, L/P, ...]`` (``split_stages``), the stages' inputs and outputs
``[P, mb, ...]``; the shift is a roll of that axis and the reference's
final ``psum`` a sum over it.  A mesh over distinct devices raises
``NotImplementedError``: their placement is ROADMAP item A.3's open part.

Constraints (the reference's): homogeneous stacked layers [L, ...] with
L % P == 0; global batch % n_micro == 0; the residual-stream shape is
constant across layers.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.sharding.api import one_device
from repro_torch.tree import leaves, tree_map

Params = Dict[str, Any]


def split_stages(stacked_params: Params, n_stages: int) -> Params:
    """[L, ...] leaves -> [P, L/P, ...] (stage-major) views."""
    def resh(x):
        L = x.shape[0]
        assert L % n_stages == 0, (L, n_stages)
        return x.reshape(n_stages, L // n_stages, *x.shape[1:])
    return tree_map(resh, stacked_params)


def pipeline_apply(layer_fn: Callable, stage_params: Params,
                   x: torch.Tensor, n_micro: int, mesh,
                   axis: str = "pipe") -> torch.Tensor:
    """Run x [B, ...] through the pipelined layer stack.

    ``layer_fn(layer_params, x_micro) -> x_micro`` applies ONE layer;
    ``stage_params`` leaves are [P, L/P, ...] (see ``split_stages``).
    Returns the full-batch output, the same on every stage."""
    one_device(mesh, x.device)
    n_stages = mesh.shape[axis]
    B = x.shape[0]
    assert B % n_micro == 0, (B, n_micro)
    mb = B // n_micro
    micro = x.reshape(n_micro, mb, *x.shape[1:])
    n_layers = leaves(stage_params)[0].shape[1]

    def stage_apply(s: int, xm: torch.Tensor) -> torch.Tensor:
        for i in range(n_layers):
            xm = layer_fn(tree_map(lambda t: t[s, i], stage_params), xm)
        return xm

    recv = torch.zeros((n_stages,) + micro.shape[1:], dtype=x.dtype,
                       device=x.device)
    collected = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        inject = micro[min(t, n_micro - 1)]
        out = torch.stack([stage_apply(s, inject if s == 0 else recv[s])
                           for s in range(n_stages)])      # [P, mb, ...]
        if t >= n_stages - 1:        # the last stage finishes a microbatch
            collected[t - (n_stages - 1)] = out[-1]
        # the stage shift: stage s receives stage s - 1's output, stage 0
        # zeros (the reference's ppermute [(i, i + 1)])
        recv = torch.cat([torch.zeros_like(out[:1]), out[:-1]])
    last = torch.stack(collected)                              # [M, mb, ...]
    # only the last stage holds real outputs: the reference's psum of the
    # stage-masked buffers, a sum over the stage axis
    outputs = torch.stack([last if s == n_stages - 1
                           else torch.zeros_like(last)
                           for s in range(n_stages)]).sum(0)
    return outputs.reshape(B, *x.shape[1:])
