"""Jamba: hybrid Mamba + attention + MoE decoder (the ``hybrid`` family).

Port of ``repro.models.jamba``.  Layers come in groups of ``attn_period``
(8): within a group the pattern is fixed (attention at ``attn_offset``,
Mamba elsewhere, MoE on the layers ``ffn_kind`` names), and the parameter
tree is the reference's: ``groups/pos{p}/...`` with leaves stacked over
the groups [G, ...]; its ``scan`` over groups is a Python loop over views
``leaf[g]``.

SWAN applies to the attention layers only (the one sequence-proportional
state); the Mamba layers keep O(1) recurrent state.  Serve state
``{"attn": the attention cache stacked [G, ...] (dense, or a SWAN hybrid
cache), "mamba{p}": {"h", "conv"} stacked [G, ...] for each Mamba
position}`` is updated IN PLACE.  The attention layer serves through the
transformer's SWAN layer (on the card, its decode read is the decode
kernel); the attention has no positional encoding (``pos = "none"``).
Like the reference's, the family has no paged layout and no chunked
prefill, its prefill takes neither a retention cap nor a bucket's true
length, and its attention layers winnow at the config's k (``swan.kk``;
a projections' per-layer ``k_layer`` is not read, as in the reference).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import absorb as absorb_mod
from repro_torch.core import hybrid_cache as hc
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (apply_norm, embed_init_, init_norm,
                                       param_generator, torch_dtype)
from repro_torch.models.mlp import mlp_forward
from repro_torch.sharding.api import shard

Params = Dict[str, Any]


def n_groups(cfg) -> int:
    if cfg.n_layers % cfg.attn_period:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is not a "
                         f"multiple of attn_period={cfg.attn_period}")
    return cfg.n_layers // cfg.attn_period


def init_lm_params(cfg, seed: int = 0, device: DeviceLike = None) -> Params:
    """Random weights from a seeded ``torch.Generator`` on ``device`` (the
    card by default), with the reference's init distributions and tree:
    each group position holds "ln1", "ln2", its mixer ("attn" or "mamba")
    and its FFN ("experts" or "mlp"), stacked over the groups."""
    dev = resolve_device(device)
    gen = param_generator(dev, seed)
    G, P, d, V = n_groups(cfg), cfg.attn_period, cfg.d_model, cfg.vocab_size
    pdt = torch_dtype(cfg.param_dtype)
    groups: Params = {}
    for pidx in range(P):
        lp: Params = {"ln1": init_norm(cfg, (G,), dev),
                      "ln2": init_norm(cfg, (G,), dev)}
        if cfg.layer_kind(pidx) == "attn":
            lp["attn"] = tfm.init_attn_params(cfg, G, gen, dev)
        else:
            lp["mamba"] = mb.init_mamba_params(cfg, G, gen, dev)
        if cfg.ffn_kind(pidx) == "moe":
            lp["experts"] = moe_mod.init_moe_params(cfg, G, gen, dev)
        else:
            lp["mlp"] = tfm.init_mlp_params(cfg, G, gen, dev)
        groups[f"pos{pidx}"] = lp
    return {"embed": embed_init_(torch.empty((V, d), dtype=pdt, device=dev),
                                 gen),
            "groups": groups, "ln_f": init_norm(cfg, (), dev),
            "head": embed_init_(torch.empty((d, V), dtype=pdt, device=dev),
                                gen)}


def group_params(p: Params, g: int) -> Params:
    """Group ``g``'s parameters: views into the stacked [G, ...] leaves."""
    return tfm.layer_params({"layers": p["groups"]}, g)


def _embed(p: Params, cfg, tokens: torch.Tensor):
    x = p["embed"][tokens.long()].to(torch_dtype(cfg.dtype))
    B, S = tokens.shape
    return x, torch.arange(S, device=x.device)[None].expand(B, S)


def _head(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    return apply_norm(p["ln_f"], cfg, x) @ p["head"].to(x.dtype)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _sublayer(lp: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    """One layer of the training forward: (x, its MoE aux loss, 0 for an
    MLP layer).  A MoE layer drops past the capacity factor."""
    h = apply_norm(lp["ln1"], cfg, x)
    if "attn" in lp:
        h = attn.attn_forward(lp["attn"], cfg, h, positions)
    else:
        h = mb.mamba_forward(lp["mamba"], cfg, h)
    x = shard(x + h, "residual")
    h = apply_norm(lp["ln2"], cfg, x)
    if "experts" in lp:
        h, a = moe_mod.moe_forward(lp["experts"], cfg, h)
        aux = a["moe_load_balance"] + a["moe_router_z"]
    else:
        h = mlp_forward(lp["mlp"], cfg, h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return shard(x + h, "residual"), aux


def _group_forward(gp: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for pidx in range(cfg.attn_period):
        x, a = _sublayer(gp[f"pos{pidx}"], cfg, x, positions)
        aux = aux + a
    return x, aux


def lm_forward_aux(p: Params, cfg, tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V], the MoE layers' summed aux
    loss).  Differentiable in ``p``; with ``cfg.remat``, under autograd,
    each group is recomputed in the backward (the reference checkpoints its
    group body)."""
    x, positions = _embed(p, cfg, tokens)
    x = shard(x, "residual")
    body = (tfm._remat(_group_forward, cfg) if torch.is_grad_enabled()
            else _group_forward)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(n_groups(cfg)):
        x, a = body(group_params(p, g), cfg, x, positions)
        aux = aux + a
    return shard(_head(p, cfg, x), "logits"), aux


# ---------------------------------------------------------------------------
# SWAN calibration (attention layers only) + absorption
# ---------------------------------------------------------------------------

@torch.no_grad()
def collect_qkv(p: Params, cfg, tokens: torch.Tensor):
    """The attention layers' q/k/v (no RoPE: ``pos = "none"``) stacked over
    the groups, and their wo: (q [G,B,S,H,dh], k [G,B,S,Kv,dh], v, wo
    [G, H·dh, d]).  The layers run as in training (MoE layers drop past
    capacity), as in the reference."""
    x, positions = _embed(p, cfg, tokens)
    apos = cfg.attn_offset
    qs, ks, vs = [], [], []
    for g in range(n_groups(cfg)):
        gp = group_params(p, g)
        for pidx in range(cfg.attn_period):
            lp = gp[f"pos{pidx}"]
            if pidx == apos:
                q, k, v = attn.project_qkv(lp["attn"], cfg,
                                           apply_norm(lp["ln1"], cfg, x),
                                           positions)
                qs.append(q)
                ks.append(k)
                vs.append(v)
            x, _ = _sublayer(lp, cfg, x, positions)
    return (torch.stack(qs), torch.stack(ks), torch.stack(vs),
            p["groups"][f"pos{apos}"]["attn"]["wo"])


def absorb_swan(p: Params, cfg, projections: Params) -> Params:
    """Fold P_VO into the attention layers' Ŵ_V/Ŵ_O; every other leaf is
    shared."""
    key = f"pos{cfg.attn_offset}"
    gp = dict(p["groups"][key])
    gp["attn"] = absorb_mod.absorb_vo(gp["attn"], projections["p_vo"],
                                      cfg.n_heads, cfg.n_kv_heads,
                                      cfg.d_head)
    return {**p, "groups": {**p["groups"], key: gp}}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_serve_state(cfg, swan, batch: int, max_seq: int,
                     device: DeviceLike = None) -> Params:
    """The attention cache (dense when ``swan`` is None) and each Mamba
    position's recurrent state, all stacked over the groups."""
    dev = resolve_device(device)
    G = n_groups(cfg)
    if swan is not None and swan.enabled:
        acache = hc.init_swan_cache(cfg, swan, batch, max_seq, dev, lead=(G,))
    else:
        acache = attn.init_dense_cache(cfg, batch, max_seq, dev, lead=(G,))
    state: Params = {"attn": acache}
    for pidx in range(cfg.attn_period):
        if pidx != cfg.attn_offset:
            state[f"mamba{pidx}"] = mb.init_mamba_state(cfg, batch, dev,
                                                        lead=(G,))
    return state


@torch.no_grad()
def prefill(p: Params, cfg, tokens: torch.Tensor, state: Params, swan=None,
            projections: Optional[Params] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Process the prompt [B, S]: the attention caches and the Mamba states
    are overwritten in place (each Mamba state from its layer's own chunked
    scan).  Returns (last-token logits [B, 1, V], state)."""
    x, positions = _embed(p, cfg, tokens)
    use_swan = swan is not None and swan.enabled
    apos = cfg.attn_offset
    for g in range(n_groups(cfg)):
        gp = group_params(p, g)
        st = tfm.layer_cache(state, g)
        for pidx in range(cfg.attn_period):
            lp = gp[f"pos{pidx}"]
            h = apply_norm(lp["ln1"], cfg, x)
            if pidx == apos:
                if use_swan:
                    h = tfm._swan_layer_prefill(
                        lp, projections["p_qk"][g], st["attn"], cfg, swan, h,
                        positions, None)
                else:
                    q, k, v = attn.project_qkv(lp["attn"], cfg, h, positions)
                    attn.dense_cache_insert_(st["attn"], k, v, 0)
                    h = attn.output_proj(lp["attn"],
                                         attn.causal_attention(q, k, v))
            else:
                h, new = mb.mamba_forward(lp["mamba"], cfg, h,
                                          return_state=True)
                for name, t in new.items():
                    st[f"mamba{pidx}"][name].copy_(t)
            x = tfm._layer_ffn(lp, cfg, x + h)
    return _head(p, cfg, x[:, -1:]), state


@torch.no_grad()
def decode_step(p: Params, cfg, token: torch.Tensor, pos, state: Params,
                swan=None, projections: Optional[Params] = None
                ) -> Tuple[torch.Tensor, Params]:
    """token [B] at ``pos`` (a python int or [B]) -> (logits [B, V], state
    updated in place).  Lanes with pos < 0 are dead: their attention rows
    and their Mamba states stay as they were."""
    B = token.shape[0]
    x = p["embed"][token.long()[:, None]].to(torch_dtype(cfg.dtype))
    pos = hc.per_seq_pos(pos, B, x.device)
    live = pos >= 0
    use_swan = swan is not None and swan.enabled
    apos = cfg.attn_offset
    for g in range(n_groups(cfg)):
        gp = group_params(p, g)
        st = tfm.layer_cache(state, g)
        for pidx in range(cfg.attn_period):
            lp = gp[f"pos{pidx}"]
            h = apply_norm(lp["ln1"], cfg, x)
            if pidx == apos:
                if use_swan:
                    h = tfm._swan_layer_decode(
                        lp, projections["p_qk"][g], st["attn"], cfg, swan, h,
                        pos, None)
                else:
                    h, _ = attn.attn_decode_dense(lp["attn"], cfg, h, pos,
                                                  st["attn"])
            else:
                h = mb.mamba_decode_step(lp["mamba"], cfg, h,
                                         st[f"mamba{pidx}"], live)
            x = tfm._layer_ffn(lp, cfg, x + h)
    return _head(p, cfg, x)[:, 0], state
