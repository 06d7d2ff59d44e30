"""RWKV-6 language model (the ``ssm`` family): embed -> [time mix + channel
mix] x L -> head.

Port of ``repro.models.rwkv_model``.  Parameters are the reference's tree
with stacked [L, ...] layer leaves (``layers/{ln1, tm, ln2, cm}``).  There
is no KV cache: the serve state is O(1) per layer (``S``, ``x_tm``,
``x_cm`` stacked [L, ...]), so SWAN is inapplicable and the family has no
calibration capture.  Prefill rebuilds every layer's state from one
chunked pass and overwrites the state in place; decode advances it in
place, dead lanes (pos < 0) keeping theirs.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import hybrid_cache as hc
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import rwkv
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (apply_norm, embed_init_, init_norm,
                                       param_generator, torch_dtype)
from repro_torch.sharding.api import shard

Params = Dict[str, Any]


def init_lm_params(cfg, seed: int = 0, device: DeviceLike = None) -> Params:
    """Random weights from a seeded ``torch.Generator`` on ``device`` (the
    card by default), with the reference's init distributions and tree."""
    dev = resolve_device(device)
    gen = param_generator(dev, seed)
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    pdt = torch_dtype(cfg.param_dtype)
    layers = {"ln1": init_norm(cfg, (L,), dev),
              "tm": rwkv.init_time_mix_params(cfg, L, gen, dev),
              "ln2": init_norm(cfg, (L,), dev),
              "cm": rwkv.init_channel_mix_params(cfg, L, gen, dev)}
    return {"embed": embed_init_(torch.empty((V, d), dtype=pdt, device=dev),
                                 gen),
            "layers": layers, "ln_f": init_norm(cfg, (), dev),
            "head": embed_init_(torch.empty((d, V), dtype=pdt, device=dev),
                                gen)}


def _head(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    return apply_norm(p["ln_f"], cfg, x) @ p["head"].to(x.dtype)


def _layer(lp: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    x = shard(x + rwkv.time_mix_forward(lp["tm"], cfg,
                                        apply_norm(lp["ln1"], cfg, x)),
              "residual")
    return shard(x + rwkv.channel_mix_forward(lp["cm"], cfg,
                                              apply_norm(lp["ln2"], cfg, x)),
                 "residual")


def lm_forward_aux(p: Params, cfg, tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V], a zero aux loss).
    Differentiable in ``p``; with ``cfg.remat``, under autograd, each layer
    is recomputed in the backward."""
    x = shard(p["embed"][tokens.long()].to(torch_dtype(cfg.dtype)),
              "residual")
    body = tfm._remat(_layer, cfg) if torch.is_grad_enabled() else _layer
    for i in range(cfg.n_layers):
        x = body(tfm.layer_params(p, i), cfg, x)
    return (shard(_head(p, cfg, x), "logits"),
            torch.zeros((), dtype=torch.float32, device=x.device))


def init_serve_state(cfg, swan, batch: int, max_seq: int,
                     device: DeviceLike = None) -> Params:
    """Each layer's recurrent state, stacked [L, ...]; ``max_seq`` sizes
    nothing (the state is O(1)).  SWAN is refused: there is no KV cache."""
    if swan is not None and swan.enabled:
        raise ValueError("SWAN is inapplicable to rwkv6 (no KV cache)")
    return rwkv.init_rwkv_state(cfg, batch, resolve_device(device),
                                lead=(cfg.n_layers,))


@torch.no_grad()
def prefill(p: Params, cfg, tokens: torch.Tensor, state: Params, swan=None,
            projections: Optional[Params] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Chunked (parallel) prefill: one pass rebuilds every layer's state,
    written in place.  Returns (last-token logits [B, 1, V], state)."""
    x = shard(p["embed"][tokens.long()].to(torch_dtype(cfg.dtype)),
              "residual")
    for i in range(cfg.n_layers):
        lp, st = tfm.layer_params(p, i), tfm.layer_cache(state, i)
        xin = apply_norm(lp["ln1"], cfg, x)
        h, S_fin = rwkv.time_mix_forward(lp["tm"], cfg, xin,
                                         return_state=True)
        st["S"].copy_(S_fin)
        st["x_tm"].copy_(xin[:, -1:])
        x = x + h
        xin = apply_norm(lp["ln2"], cfg, x)
        x = x + rwkv.channel_mix_forward(lp["cm"], cfg, xin)
        st["x_cm"].copy_(xin[:, -1:])
    return _head(p, cfg, x[:, -1:]), state


@torch.no_grad()
def decode_step(p: Params, cfg, token: torch.Tensor, pos, state: Params,
                swan=None, projections: Optional[Params] = None
                ) -> Tuple[torch.Tensor, Params]:
    """token [B] -> (logits [B, V], state advanced in place).  ``pos`` (a
    python int or [B]) only marks the dead lanes (pos < 0), whose state
    stays as it was."""
    B = token.shape[0]
    x = p["embed"][token.long()[:, None]].to(torch_dtype(cfg.dtype))
    live = hc.per_seq_pos(pos, B, x.device) >= 0
    for i in range(cfg.n_layers):
        lp, st = tfm.layer_params(p, i), tfm.layer_cache(state, i)
        x = x + rwkv.time_mix_decode(lp["tm"], cfg,
                                     apply_norm(lp["ln1"], cfg, x), st, live)
        x = x + rwkv.channel_mix_decode(lp["cm"], cfg,
                                        apply_norm(lp["ln2"], cfg, x), st,
                                        live)
    return _head(p, cfg, x)[:, 0], state
