"""AdamW on parameter trees of tensors (port of ``repro.optim.adamw``):
decoupled weight decay, global-norm gradient clipping, warmup + cosine
decay, configurable moment dtype.

Moments are stored in ``OptimizerConfig.state_dtype`` and updated in
float32; parameters are updated in float32 and cast back to their dtype
(bf16 params stay bf16).  The update runs in place.  The schedule and the
bias corrections are f32 tensor arithmetic on the step counter, as in the
reference, so nothing here reads a value back to the host.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.common import torch_dtype
from repro_torch.tree import flatten_with_path, leaves, tree_map, unflatten

Params = Dict[str, Any]


def init_opt_state(params: Params, opt_cfg) -> Params:
    sdt = torch_dtype(opt_cfg.state_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=sdt, device=p.device)
    dev = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def lr_schedule(step: torch.Tensor, opt_cfg) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio (f32, on ``step``'s
    device)."""
    step = step.float()
    warm = opt_cfg.lr * (step + 1.0) / max(opt_cfg.warmup_steps, 1)
    prog = torch.clamp((step - opt_cfg.warmup_steps) /
                       max(opt_cfg.decay_steps - opt_cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = opt_cfg.min_lr_ratio + (1 - opt_cfg.min_lr_ratio) * \
        0.5 * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < opt_cfg.warmup_steps, warm, opt_cfg.lr * cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    # a true f32 division (a Python scalar over a tensor multiplies by
    # the reciprocal in torch)
    return torch.clamp(torch.full_like(gn, max_norm) /
                       torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


_NO_DECAY = ("scale", "bias", "ln", "dt_bias", "decay_w", "bonus_u", "mix",
             "gn_scale", "gn_bias", "a_log", "d_skip")


def _decay_mask(params) -> Params:
    """1.0 for a leaf that takes weight decay, 0.0 otherwise: matrices
    decay unless their path names a norm, bias or gate parameter (a
    stacked ``layers/ln1/scale`` is 2-D and still does not)."""
    flat = flatten_with_path(params)
    return unflatten(params, [
        1.0 if leaf.dim() >= 2 and not any(t in name for t in _NO_DECAY)
        else 0.0 for name, leaf in flat])


@torch.no_grad()
def adamw_update(params: Params, grads: Params, state: Params, opt_cfg
                 ) -> Tuple[Params, Params, Dict[str, torch.Tensor]]:
    """One AdamW step, IN PLACE: every parameter and moment leaf is
    overwritten (one leaf at a time, so the step needs no second copy of
    the model).  Returns (params, state, metrics), the same trees with a
    new step counter."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, opt_cfg.grad_clip)
    step = state["step"] + 1
    lr = lr_schedule(state["step"], opt_cfg)
    b1, b2 = opt_cfg.betas
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for p, g, m, v, dmask in zip(
            leaves(params), leaves(grads), leaves(state["m"]),
            leaves(state["v"]), leaves(_decay_mask(params))):
        # the clipped gradient in its own dtype, as clip_by_global_norm
        # gives it, made leaf by leaf: no clipped copy of the whole tree
        g32 = (g.float() * scale).to(g.dtype).float()
        m32 = m.float() * b1 + g32 * (1 - b1)
        v32 = v.float() * b2 + torch.square(g32) * (1 - b2)
        update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + opt_cfg.eps)
        update = update + opt_cfg.weight_decay * dmask * p.float()
        p.copy_(p.float() - lr * update)
        m.copy_(m32)
        v.copy_(v32)
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gn, "lr": lr}
