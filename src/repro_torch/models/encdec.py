"""Whisper-style encoder-decoder transformer (the ``encdec`` family).

Port of ``repro.models.encdec``.  The conv audio frontend is a stub, as in
the reference: the model takes precomputed frame embeddings [B, F, d]
(``launch.io.make_batch`` draws them).  The encoder runs once per prefill;
each decoder layer's cross-attention keys and values are computed once from
its output into a static cache, which ``SwanConfig.compress_cross_attn``
winnows once (top-k of the unrotated vectors, no ring: those entries are
never recent context).  The decoder's self-attention cache is dense or a
SWAN hybrid cache, read by the transformer's SWAN layer (on the card,
through the decode kernel); the encoder's attention, the cross-attention
and the cross cache's winnowing are plain PyTorch, as the reference leaves
them to XLA.  Serve state is updated IN PLACE.

Parameters: ``{"enc": {"pos_embed" [F, d], "layers", "ln_f"}, "dec":
{"embed" [V, d], "pos_embed" [max_position_learned, d], "layers", "ln_f"}}``
with stacked [L, ...] layer leaves; a decoder layer holds "ln1", "attn",
"ln_x", "cross", "ln2", "mlp"; the head is ``dec.embed.T``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import absorb as absorb_mod
from repro_torch.core.hybrid_cache import _bits, packed_side
from repro_torch.core.winnow import unpack_dense, winnow_vector
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (apply_norm, embed_init_, init_norm,
                                       param_generator, torch_dtype)
from repro_torch.models.mlp import mlp_forward
from repro_torch.sharding.api import shard

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_lm_params(cfg, seed: int = 0, device: DeviceLike = None) -> Params:
    """Random weights from a seeded ``torch.Generator`` on ``device`` (the
    card by default) with the reference's init distributions and tree:
    the encoder and decoder stacks, both positional tables, zero biases
    where the config's flags put them."""
    dev = resolve_device(device)
    gen = param_generator(dev, seed)
    Le, L, d = cfg.n_encoder_layers, cfg.n_layers, cfg.d_model
    pdt = torch_dtype(cfg.param_dtype)

    def table(rows):
        return embed_init_(torch.empty((rows, d), dtype=pdt, device=dev), gen)

    enc_layers = {"ln1": init_norm(cfg, (Le,), dev),
                  "attn": tfm.init_attn_params(cfg, Le, gen, dev),
                  "ln2": init_norm(cfg, (Le,), dev),
                  "mlp": tfm.init_mlp_params(cfg, Le, gen, dev)}
    dec_layers = {"ln1": init_norm(cfg, (L,), dev),
                  "attn": tfm.init_attn_params(cfg, L, gen, dev),
                  "ln_x": init_norm(cfg, (L,), dev),
                  "cross": tfm.init_attn_params(cfg, L, gen, dev),
                  "ln2": init_norm(cfg, (L,), dev),
                  "mlp": tfm.init_mlp_params(cfg, L, gen, dev)}
    return {"enc": {"pos_embed": table(cfg.encoder_seq), "layers": enc_layers,
                    "ln_f": init_norm(cfg, (), dev)},
            "dec": {"embed": table(cfg.vocab_size),
                    "pos_embed": table(cfg.max_position_learned()),
                    "layers": dec_layers, "ln_f": init_norm(cfg, (), dev)}}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _enc_layer(lp: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    h = attn.attn_forward(lp["attn"], cfg, apply_norm(lp["ln1"], cfg, x),
                          causal=False)
    x = x + h
    return x + mlp_forward(lp["mlp"], cfg, apply_norm(lp["ln2"], cfg, x))


def encode(p: Params, cfg, frames: torch.Tensor) -> torch.Tensor:
    """frames [B, F, d] (stub embeddings) -> encoder output [B, F, d]:
    learned positions, then pre-norm layers of non-causal attention."""
    F = frames.shape[1]
    x = frames.to(torch_dtype(cfg.dtype))
    x = shard(x + p["enc"]["pos_embed"][None, :F].to(x.dtype), "enc_out")
    body = (tfm._remat(_enc_layer, cfg) if torch.is_grad_enabled()
            else _enc_layer)
    for i in range(cfg.n_encoder_layers):
        x = body(tfm.layer_params(p["enc"], i), cfg, x)
    return apply_norm(p["enc"]["ln_f"], cfg, x)


def _dec_embed(p: Params, cfg, tokens: torch.Tensor, positions: torch.Tensor
               ) -> torch.Tensor:
    x = p["dec"]["embed"][tokens.long()].to(torch_dtype(cfg.dtype))
    return x + tfm.learned_positions(p["dec"]["pos_embed"], positions,
                                     x.dtype)


def _dec_layer(lp: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
               enc_out: torch.Tensor) -> torch.Tensor:
    x = x + attn.attn_forward(lp["attn"], cfg,
                              apply_norm(lp["ln1"], cfg, x), positions)
    x = x + attn.attn_forward(lp["cross"], cfg,
                              apply_norm(lp["ln_x"], cfg, x), kv_x=enc_out)
    return x + mlp_forward(lp["mlp"], cfg, apply_norm(lp["ln2"], cfg, x))


def _head(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """The decoder's final norm and its head, tied to the embedding (a
    transposed view, as the transformer's tied head)."""
    return (apply_norm(p["dec"]["ln_f"], cfg, x)
            @ p["dec"]["embed"].T.to(x.dtype))


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device)[None].expand(B, S)


def lm_forward_aux(p: Params, cfg, tokens: torch.Tensor,
                   frames: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] and frames [B, F, d] -> (logits [B, S, V], a zero aux
    loss).  Differentiable in ``p``; with ``cfg.remat``, under autograd,
    each layer is recomputed in the backward."""
    enc_out = encode(p, cfg, frames)
    positions = _positions(tokens)
    x = shard(_dec_embed(p, cfg, tokens, positions), "residual")
    body = (tfm._remat(_dec_layer, cfg) if torch.is_grad_enabled()
            else _dec_layer)
    for i in range(cfg.n_layers):
        x = body(tfm.layer_params(p["dec"], i), cfg, x, positions, enc_out)
    return (shard(_head(p, cfg, x), "logits"),
            torch.zeros((), dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------------------
# SWAN calibration (decoder self-attention) + absorption
# ---------------------------------------------------------------------------

@torch.no_grad()
def collect_qkv(p: Params, cfg, tokens: torch.Tensor, frames: torch.Tensor):
    """The decoder self-attention's per-layer q/k/v (no RoPE: learned
    positions) and wo, as ``transformer.collect_qkv`` returns them."""
    enc_out = encode(p, cfg, frames)
    positions = _positions(tokens)
    x = _dec_embed(p, cfg, tokens, positions)
    qs, ks, vs = [], [], []
    for i in range(cfg.n_layers):
        lp = tfm.layer_params(p["dec"], i)
        q, k, v = attn.project_qkv(lp["attn"], cfg,
                                   apply_norm(lp["ln1"], cfg, x), positions)
        qs.append(q)
        ks.append(k)
        vs.append(v)
        x = _dec_layer(lp, cfg, x, positions, enc_out)
    return (torch.stack(qs), torch.stack(ks), torch.stack(vs),
            p["dec"]["layers"]["attn"]["wo"])


def absorb_swan(p: Params, cfg, projections: Params) -> Params:
    """Fold P_VO into the decoder self-attention's Ŵ_V/Ŵ_O (and b̂_v);
    every other leaf is shared."""
    layers = dict(p["dec"]["layers"])
    layers["attn"] = absorb_mod.absorb_vo(
        layers["attn"], projections["p_vo"], cfg.n_heads, cfg.n_kv_heads,
        cfg.d_head)
    return {"enc": p["enc"], "dec": {**p["dec"], "layers": layers}}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_serve_state(cfg, swan, batch: int, max_seq: int,
                     device: DeviceLike = None) -> Params:
    """``{"self": the decoder's stacked self-attention cache (dense, or a
    SWAN hybrid cache), "cross": the static cross cache}``: k/v [L, B, Kv,
    F, dh] in the activation dtype, or, with SWAN and
    ``compress_cross_attn``, packed sides [L, B, Kv, F, k_max]."""
    dev = resolve_device(device)
    use_swan = swan is not None and swan.enabled
    L, Kv, dh, F = cfg.n_layers, cfg.n_kv_heads, cfg.d_head, cfg.encoder_seq
    if use_swan and swan.compress_cross_attn:
        cross = {n: packed_side(cfg, swan, (L, batch, Kv, F), dev)
                 for n in ("k", "v")}
    else:
        cross = {n: torch.zeros((L, batch, Kv, F, dh),
                                dtype=torch_dtype(cfg.dtype), device=dev)
                 for n in ("k", "v")}
    return {"self": tfm.init_caches(cfg, swan, batch, max_seq, dev),
            "cross": cross}


def _expand(side, dh: int) -> torch.Tensor:
    """A cross cache side as dense f32 [B, Kv, F, dh]: packed vectors are
    dequantized and scattered (``unpack_dense``), plain ones widened."""
    if not isinstance(side, dict):
        return side.float()
    vals = side["vals"].float()
    if "scale" in side:
        vals = vals * side["scale"][..., None]
    return unpack_dense(vals, side.get("idx"), dh)


def _cross_attend(lp: Params, cfg, x: torch.Tensor, cross: Params
                  ) -> torch.Tensor:
    """Cross-attention of x [B, Sq, d] against a layer's static cache
    (winnowed or not), in f32 as the reference: its ``_cross_attend``."""
    B, Sq, _ = x.shape
    H, Kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = x @ lp["wq"]
    if "bq" in lp:
        q = q + lp["bq"]
    kc, vc = _expand(cross["k"], dh), _expand(cross["v"], dh)
    qh = q.reshape(B, Sq, Kv, H // Kv, dh).permute(0, 2, 3, 1, 4)
    s = torch.einsum("bngqd,bnsd->bngqs", qh.float(), kc) / math.sqrt(dh)
    o = torch.einsum("bngqs,bnsd->bngqd", torch.softmax(s, dim=-1), vc)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dh).to(x.dtype)
    return attn.output_proj(lp, o)


def _fill_cross_(cross_l: Params, lp: Params, cfg, swan,
                 enc_out: torch.Tensor) -> None:
    """Write one layer's static cross cache from the encoder's output, in
    place: winnowed once (``winnow_vector`` at the config's k, no
    rotation) when the cache is packed."""
    for name, t in zip("kv", attn.cross_kv(lp, cfg, enc_out)):
        t = t.transpose(1, 2)                           # [B, Kv, F, dh]
        dst = cross_l[name]
        if isinstance(dst, dict):
            for leaf, val in winnow_vector(t, swan, name).items():
                _bits(dst[leaf]).copy_(_bits(val))
        else:
            dst.copy_(t)


@torch.no_grad()
def prefill(p: Params, cfg, tokens: torch.Tensor, state: Params, swan=None,
            projections: Optional[Params] = None,
            frames: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Encode ``frames``, fill each decoder layer's cross cache and its
    self-attention cache with the prompt [B, S], in place.  Returns
    (last-token logits [B, 1, V], state)."""
    enc_out = encode(p, cfg, frames)
    positions = _positions(tokens)
    x = _dec_embed(p, cfg, tokens, positions)
    use_swan = swan is not None and swan.enabled
    for i in range(cfg.n_layers):
        lp = tfm.layer_params(p["dec"], i)
        self_l = tfm.layer_cache(state["self"], i)
        cross_l = tfm.layer_cache(state["cross"], i)
        h = apply_norm(lp["ln1"], cfg, x)
        if use_swan:
            h = tfm._swan_layer_prefill(lp, projections["p_qk"][i], self_l,
                                        cfg, swan, h, positions, None)
        else:
            q, k, v = attn.project_qkv(lp["attn"], cfg, h, positions)
            attn.dense_cache_insert_(self_l, k, v, 0)
            h = attn.output_proj(lp["attn"], attn.causal_attention(q, k, v))
        x = x + h
        _fill_cross_(cross_l, lp["cross"], cfg, swan, enc_out)
        x = x + _cross_attend(lp["cross"], cfg,
                              apply_norm(lp["ln_x"], cfg, x), cross_l)
        x = x + mlp_forward(lp["mlp"], cfg, apply_norm(lp["ln2"], cfg, x))
    return _head(p, cfg, x[:, -1:]), state


@torch.no_grad()
def decode_step(p: Params, cfg, token: torch.Tensor, pos, state: Params,
                swan=None, projections: Optional[Params] = None
                ) -> Tuple[torch.Tensor, Params]:
    """token [B] at ``pos`` (a python int or [B]; lanes with pos < 0 are
    dead) -> (logits [B, V], state updated in place): the self-attention
    through the dense or SWAN cache, the cross-attention over the static
    cache."""
    B = token.shape[0]
    x = p["dec"]["embed"][token.long()[:, None]].to(torch_dtype(cfg.dtype))
    pos = tfm.hc.per_seq_pos(pos, B, x.device)
    x = x + tfm.learned_positions(p["dec"]["pos_embed"], pos[:, None],
                                  x.dtype)
    use_swan = swan is not None and swan.enabled
    for i in range(cfg.n_layers):
        lp = tfm.layer_params(p["dec"], i)
        self_l = tfm.layer_cache(state["self"], i)
        h = apply_norm(lp["ln1"], cfg, x)
        if use_swan:
            h = tfm._swan_layer_decode(lp, projections["p_qk"][i], self_l,
                                       cfg, swan, h, pos, None)
        else:
            h, _ = attn.attn_decode_dense(lp["attn"], cfg, h, pos, self_l)
        x = x + h
        x = x + _cross_attend(lp["cross"], cfg,
                              apply_norm(lp["ln_x"], cfg, x),
                              tfm.layer_cache(state["cross"], i))
        x = x + mlp_forward(lp["mlp"], cfg, apply_norm(lp["ln2"], cfg, x))
    return _head(p, cfg, x)[:, 0], state
