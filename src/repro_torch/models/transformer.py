"""Decoder-only transformer LM, dense family: forward, SWAN calibration
capture and absorption, and serving (prefill + decode over a dense or SWAN
hybrid cache, slab layout).

Port of ``repro.models.transformer``.  Parameters are nested dicts with
stacked ``[L, ...]`` layer leaves, as in the reference; its ``scan`` over
layers is a Python loop over views ``leaf[i]``.  Serve caches are stacked
``[L, ...]`` too and are updated IN PLACE by prefill and decode.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import absorb as absorb_mod
from repro_torch.core import hybrid_cache as hc
from repro_torch.core import swan_attention as swa
from repro_torch.core.winnow import rotate_k, rotate_q
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.dispatch import decode_kernel_supported
from repro_torch.kernels.swan_decode.ops import swan_decode_from_cache
from repro_torch.models import attention as attn
from repro_torch.models.common import (apply_norm, dense_init_, embed_init_,
                                       torch_dtype)
from repro_torch.models.mlp import mlp_forward

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_lm_params(cfg, seed: int = 0, device: DeviceLike = None) -> Params:
    """Random weights from a seeded ``torch.Generator`` on ``device`` (the
    card by default), with the reference's init distributions.  Each
    stacked leaf is allocated once and filled layer by layer."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, d, ff, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, Kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    pdt = torch_dtype(cfg.param_dtype)

    def empty(*shape):
        return torch.empty(shape, dtype=pdt, device=dev)

    def stacked(d_in, d_out, scale=None):
        w = empty(L, d_in, d_out)
        for i in range(L):
            dense_init_(w[i], gen, scale)
        return w

    def norm(*lead):
        return {"scale": torch.ones((*lead, d), dtype=pdt, device=dev)}

    layers = {
        "ln1": norm(L),
        "attn": {"wq": stacked(d, H * dh), "wk": stacked(d, Kv * dh),
                 "wv": stacked(d, Kv * dh),
                 "wo": stacked(H * dh, d, (H * dh) ** -0.5)},
        "ln2": norm(L),
        "mlp": {},
    }
    if cfg.act == "silu":                    # SwiGLU: a gate beside w_up
        layers["mlp"]["w_gate"] = stacked(d, ff)
    layers["mlp"].update(w_up=stacked(d, ff),
                         w_down=stacked(ff, d, ff ** -0.5))
    return {"embed": embed_init_(empty(V, d), gen), "layers": layers,
            "ln_f": norm(),
            "head": embed_init_(empty(d, V), gen)}   # the reference's embed.T


def layer_params(p: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the stacked [L, ...] leaves."""
    def pick(tree):
        if isinstance(tree, dict):
            return {k: pick(v) for k, v in tree.items()}
        return tree[i]
    return pick(p["layers"])


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _embed(p: Params, cfg, tokens: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    x = p["embed"][tokens.long()].to(torch_dtype(cfg.dtype))
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    return x, positions


def _head(p: Params, x: torch.Tensor) -> torch.Tensor:
    return apply_norm(p["ln_f"], x) @ p["head"].to(x.dtype)


def _layer_ffn(lp: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    return x + mlp_forward(lp["mlp"], cfg, apply_norm(lp["ln2"], x))


def _layer_qkv_forward(lp: Params, cfg, x: torch.Tensor,
                       positions: torch.Tensor):
    """Pre-norm block; also returns the block's post-RoPE q, k, v."""
    h = apply_norm(lp["ln1"], x)
    q, k, v = attn.project_qkv(lp["attn"], cfg, h, positions)
    o = attn.causal_attention(q, k, v)
    x = x + attn.output_proj(lp["attn"], o)
    return _layer_ffn(lp, cfg, x), (q, k, v)


@torch.no_grad()
def lm_forward(p: Params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] (the dense family has no aux loss)."""
    x, positions = _embed(p, cfg, tokens)
    for i in range(cfg.n_layers):
        x, _ = _layer_qkv_forward(layer_params(p, i), cfg, x, positions)
    return _head(p, x)


# ---------------------------------------------------------------------------
# SWAN calibration + absorption
# ---------------------------------------------------------------------------

@torch.no_grad()
def collect_qkv(p: Params, cfg, tokens: torch.Tensor):
    """Run the model, capturing per-layer post-RoPE q/k and v (§4.1.1).

    Returns (q [L,B,S,H,dh], k [L,B,S,Kv,dh], v [L,B,S,Kv,dh], wo [L,H·dh,d])."""
    x, positions = _embed(p, cfg, tokens)
    qs, ks, vs = [], [], []
    for i in range(cfg.n_layers):
        x, (q, k, v) = _layer_qkv_forward(layer_params(p, i), cfg, x,
                                          positions)
        qs.append(q)
        ks.append(k)
        vs.append(v)
    return (torch.stack(qs), torch.stack(ks), torch.stack(vs),
            p["layers"]["attn"]["wo"])


def absorb_swan(p: Params, cfg, projections: Params) -> Params:
    """Fold P_VO into the stacked attention weights (lossless, Lemma A.2).
    Returns new params sharing every leaf but Ŵ_V/Ŵ_O (and b̂_v)."""
    out = dict(p)
    layers = dict(p["layers"])
    layers["attn"] = absorb_mod.absorb_vo(
        p["layers"]["attn"], projections["p_vo"], cfg.n_heads,
        cfg.n_kv_heads, cfg.d_head)
    out["layers"] = layers
    return out


# ---------------------------------------------------------------------------
# Serving: caches, prefill, decode
# ---------------------------------------------------------------------------

def init_caches(cfg, swan, batch: int, max_seq: int,
                device: DeviceLike = None) -> Params:
    """Stacked [L, ...] caches; ``swan`` None -> dense baseline cache."""
    dev = resolve_device(device)
    if swan is None or not swan.enabled:
        return attn.init_dense_cache(cfg, batch, max_seq, dev,
                                     lead=(cfg.n_layers,))
    return hc.init_swan_cache(cfg, swan, batch, max_seq, dev,
                              lead=(cfg.n_layers,))


def layer_cache(caches: Params, i: int) -> Params:
    """Layer ``i``'s cache: views, so in-place updates land in ``caches``."""
    return {k: (layer_cache(v, i) if isinstance(v, dict) else v[i])
            for k, v in caches.items()}


def _k_per_layer(cfg, swan, projections) -> list:
    """Per-layer runtime retention handed to every winnow (the reference's
    ``_swan_scan_xs``: projections may carry 'k_layer' [L])."""
    k_layer = projections.get("k_layer")
    if k_layer is None:
        return [swan.kk] * cfg.n_layers
    return [int(k) for k in k_layer]


def _swan_layer_decode(lp: Params, p_qk_l: torch.Tensor, cache_l: Params,
                       cfg, swan, x: torch.Tensor, pos: torch.Tensor,
                       k_act) -> torch.Tensor:
    """One layer's SWAN decode: insert into the hybrid cache (in place),
    then read it — through the CUDA kernel when the cache is on the card,
    through the plain gather/scatter path otherwise."""
    B = x.shape[0]
    Kv, G, dh = cfg.n_kv_heads, cfg.q_group, cfg.d_head
    q, k, v = attn.project_qkv(lp["attn"], cfg, x, pos[:, None])
    q_hat = rotate_q(q, p_qk_l, Kv)[:, 0]                        # [B,Kv,G,dh]
    k_hat = rotate_k(k, p_qk_l)                                  # [B,1,Kv,dh]
    hc.swan_cache_insert_decode_(cache_l, swan, k_hat, v, pos, k_act=k_act)
    if decode_kernel_supported(swan, cache_l["k"]["vals"]):
        o = swan_decode_from_cache(q_hat, cache_l, swan, pos)
    else:
        o = swa.swan_decode_attention(q_hat, cache_l, swan, pos)
    return attn.output_proj(lp["attn"], o.reshape(B, 1, Kv * G, dh))


def _swan_layer_prefill(lp: Params, p_qk_l, cache_l: Params, cfg, swan,
                        x: torch.Tensor, positions, k_act) -> torch.Tensor:
    """Prefill: dense (lossless, Lemma A.1) attention on rotated q̂/k̂/v̂;
    the hybrid cache is filled (in place) for the decode steps."""
    B, S, _ = x.shape
    Kv, G, dh = cfg.n_kv_heads, cfg.q_group, cfg.d_head
    q, k, v = attn.project_qkv(lp["attn"], cfg, x, positions)
    q_hat = rotate_q(q, p_qk_l, Kv).reshape(B, S, Kv * G, dh)
    k_hat = rotate_k(k, p_qk_l)
    hc.swan_cache_insert_prefill_(cache_l, swan, k_hat, v, k_act=k_act)
    return attn.output_proj(lp["attn"], attn.causal_attention(q_hat, k_hat, v))


@torch.no_grad()
def lm_prefill(p: Params, cfg, tokens: torch.Tensor, caches: Params,
               swan=None, projections: Optional[Params] = None
               ) -> Tuple[torch.Tensor, Params]:
    """Process the prompt [B, S], filling ``caches`` in place.  Returns
    (last-token logits [B, 1, V], caches)."""
    x, positions = _embed(p, cfg, tokens)
    use_swan = swan is not None and swan.enabled
    k_layers = _k_per_layer(cfg, swan, projections) if use_swan else None
    for i in range(cfg.n_layers):
        lp, cache_l = layer_params(p, i), layer_cache(caches, i)
        h = apply_norm(lp["ln1"], x)
        if use_swan:
            h = _swan_layer_prefill(lp, projections["p_qk"][i], cache_l, cfg,
                                    swan, h, positions, k_layers[i])
        else:
            q, k, v = attn.project_qkv(lp["attn"], cfg, h, positions)
            attn.dense_cache_insert_(cache_l, k, v, 0)
            h = attn.output_proj(lp["attn"], attn.causal_attention(q, k, v))
        x = _layer_ffn(lp, cfg, x + h)
    return _head(p, x[:, -1:]), caches


@torch.no_grad()
def lm_decode_step(p: Params, cfg, token: torch.Tensor, pos, caches: Params,
                   swan=None, projections: Optional[Params] = None
                   ) -> Tuple[torch.Tensor, Params]:
    """token [B] -> (logits [B, V], caches updated in place).  ``pos`` is a
    python int (lockstep batch) or a per-sequence [B] tensor."""
    B = token.shape[0]
    x = p["embed"][token.long()[:, None]].to(torch_dtype(cfg.dtype))
    pos = hc.per_seq_pos(pos, B, x.device)
    use_swan = swan is not None and swan.enabled
    k_layers = _k_per_layer(cfg, swan, projections) if use_swan else None
    for i in range(cfg.n_layers):
        lp, cache_l = layer_params(p, i), layer_cache(caches, i)
        h = apply_norm(lp["ln1"], x)
        if use_swan:
            h = _swan_layer_decode(lp, projections["p_qk"][i], cache_l, cfg,
                                   swan, h, pos, k_layers[i])
        else:
            h, _ = attn.attn_decode_dense(lp["attn"], cfg, h, pos, cache_l)
        x = _layer_ffn(lp, cfg, x + h)
    return _head(p, x)[:, 0], caches
