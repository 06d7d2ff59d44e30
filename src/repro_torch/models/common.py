"""Shared model building blocks: norms, RoPE, activations, initialisers.

Port of ``repro.models.common``.  Initialisers draw from an explicit
``torch.Generator`` with the reference's distributions (truncated normal
fan-in, normal 0.02 embeddings); the two frameworks give different numbers
from one seed, so parity tests carry the reference's weights across.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------

def param_generator(device: torch.device, seed: int
                    ) -> Optional[torch.Generator]:
    """The initialisers' seeded generator on ``device``; None on the
    ``meta`` device, which has none: there the initialisers only give each
    leaf its shape and dtype (a full config's tree costs no memory)."""
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def dense_init_(out: torch.Tensor, gen: Optional[torch.Generator],
                scale: Optional[float] = None) -> torch.Tensor:
    """Fill ``out [..., d_in, d_out]`` in place with truncated-normal
    fan-in weights (±3σ, as ``jax.random.truncated_normal``), drawn in f32."""
    std = scale if scale is not None else out.shape[-2] ** -0.5
    w = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return out.copy_(w.mul_(std))


def embed_init_(out: torch.Tensor, gen: Optional[torch.Generator]
                ) -> torch.Tensor:
    w = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    return out.copy_(w.normal_(0.0, 1.0, generator=gen).mul_(0.02))


def write_live_(dst: torch.Tensor, new: torch.Tensor,
                live: Optional[torch.Tensor]) -> None:
    """``dst.copy_(new)`` on the lanes (dim 0) where ``live`` [B] is True;
    a dead lane keeps its row (all lanes are live when ``live`` is None).
    The recurrent serve states' update: the engine's idle lanes and a
    graph's warm run decode at pos = -1 and must change nothing."""
    if live is not None:
        new = torch.where(live.reshape((-1,) + (1,) * (new.dim() - 1)), new,
                          dst)
    dst.copy_(new)


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------

def init_norm(cfg, lead=(), device=None) -> Params:
    """A norm's parameters for ``cfg.norm`` (the reference's ``init_norm``),
    each leaf [*lead, d_model] in ``cfg.param_dtype``: RMSNorm a scale of
    ones, LayerNorm a scale of ones and a bias of zeros, non-parametric
    LayerNorm (OLMo) nothing."""
    shape = (*lead, cfg.d_model)
    pdt = torch_dtype(cfg.param_dtype)
    if cfg.norm == "rmsnorm":
        return {"scale": torch.ones(shape, dtype=pdt, device=device)}
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(shape, dtype=pdt, device=device),
                "bias": torch.zeros(shape, dtype=pdt, device=device)}
    if cfg.norm == "nonparam_ln":
        return {}
    raise ValueError(cfg.norm)


def apply_norm(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Normalise in fp32 by ``cfg.norm`` and cast back to the activation
    dtype: RMSNorm (eps 1e-6) times its scale; LayerNorm (eps 1e-5) times
    its scale plus its bias, or, non-parametric, neither."""
    xf = x.float()
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
        xf = xf * p["scale"].float()
    else:                                           # layernorm / nonparam_ln
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + 1e-5)
        if cfg.norm == "layernorm":
            xf = xf * p["scale"].float() + p["bias"].float()
    return xf.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary positional embedding (RoPE)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def rope_freqs(d_head: int, theta: float, device: torch.device) -> torch.Tensor:
    """Inverse frequencies [d_head//2], float32, computed as the reference
    does (numpy f32).  Cached per device: the host-to-device copy would
    otherwise synchronise the host with the card at every layer.  Callers
    must not modify the returned tensor."""
    exponents = np.arange(0, d_head, 2, dtype=np.float32) / d_head
    return torch.from_numpy(np.asarray(1.0 / (theta ** exponents),
                                       np.float32)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, n_heads, d_head]; positions: [..., seq].  Half-split
    (llama) convention: rotate pairs (x[..., :d/2], x[..., d/2:])."""
    d_head = x.shape[-1]
    inv = rope_freqs(d_head, theta, x.device)                    # [d/2]
    ang = positions[..., :, None, None].float() * inv            # [..., S, 1, d/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def act_fn(name: str):
    """The reference's activations by config name; ``gelu`` is the tanh
    approximation, as ``jax.nn.gelu`` by default."""
    if name == "silu":
        return F.silu
    if name == "gelu":
        return functools.partial(F.gelu, approximate="tanh")
    if name == "relu_sq":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)

