"""Dense feed-forward blocks: SwiGLU and the 2-matrix MLP with optional
biases (port of ``repro.models.mlp``)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.common import act_fn

Params = Dict[str, Any]


def mlp_forward(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU ``(act(x W_gate) * x W_up) W_down`` when the params hold a
    gate (``act='silu'``), else ``act(x W_up + b_up) W_down + b_down``, the
    biases where the params hold them (``cfg.mlp_bias``)."""
    act = act_fn(cfg.act)
    if "w_gate" in p:
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = x @ p["w_up"]
        if "b_up" in p:
            h = h + p["b_up"]
        h = act(h)
    y = h @ p["w_down"]
    return y + p["b_down"] if "b_down" in p else y
