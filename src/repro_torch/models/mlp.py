"""Dense feed-forward block (port of ``repro.models.mlp``, without biases)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.common import act_fn

Params = Dict[str, Any]


def mlp_forward(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU ``(act(x W_gate) * x W_up) W_down`` when the params hold a
    gate (``act='silu'``), else ``act(x W_up) W_down``."""
    act = act_fn(cfg.act)
    if "w_gate" in p:
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = act(x @ p["w_up"])
    return h @ p["w_down"]
