"""Decoder-only transformer LM, dense, MoE and VLM families: the training
forward (with remat, and the MoE layers' auxiliary losses) and loss, SWAN
calibration capture and absorption, and serving (prefill, batched chunked
prefill and decode over a dense cache or a SWAN hybrid cache, slab or
paged).  A VLM's patch embeddings (``prefix_embeds`` [B, P, d]) go ahead
of the tokens in the forward, the calibration capture and the prefill,
and its loss leaves their positions out.

Port of ``repro.models.transformer``.  Parameters are nested dicts with
stacked ``[L, ...]`` layer leaves, as in the reference; its ``scan`` over
layers is a Python loop over views ``leaf[i]``.  Serve caches are stacked
``[L, ...]`` too and are updated IN PLACE by prefill, chunks and decode.
On the card the SWAN reads of decode and chunked prefill run in the CUDA
kernels (``repro_torch.kernels``; gate in ``kernels.dispatch``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.core import absorb as absorb_mod
from repro_torch.core import hybrid_cache as hc
from repro_torch.core import paged_cache as pc
from repro_torch.core import swan_attention as swa
from repro_torch.core.winnow import rotate_k, rotate_q
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.dispatch import kernel_supported
from repro_torch.kernels.swan_chunk.ops import (chunk_stats_from_pool,
                                                chunk_stats_from_view)
from repro_torch.kernels.swan_decode.ops import (
    swan_decode_from_cache, swan_decode_paged_from_cache)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (apply_norm, dense_init_, embed_init_,
                                       init_norm, param_generator,
                                       torch_dtype)
from repro_torch.models.mlp import mlp_forward
from repro_torch.sharding.api import current_rules, shard

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def stacked_weight(cfg, L: int, d_in: int, d_out: int, gen: torch.Generator,
                   dev, scale: Optional[float] = None) -> torch.Tensor:
    """A stacked [L, d_in, d_out] leaf in ``cfg.param_dtype``, filled layer
    by layer with fan-in weights (``dense_init_``)."""
    w = torch.empty((L, d_in, d_out), dtype=torch_dtype(cfg.param_dtype),
                    device=dev)
    for i in range(L):
        dense_init_(w[i], gen, scale)
    return w


def init_attn_params(cfg, L: int, gen: torch.Generator, dev) -> Params:
    """A stacked attention block (the reference's ``init_attn_params``):
    wq, wk, wv, wo drawn in that order; zero q/k/v biases with
    ``cfg.qkv_bias`` and a zero output bias with ``cfg.attn_out_bias``."""
    d, H, Kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def zeros(n):
        return torch.zeros((L, n), dtype=torch_dtype(cfg.param_dtype),
                           device=dev)

    p = {n: stacked_weight(cfg, L, d_in, d_out, gen, dev, scale)
         for n, d_in, d_out, scale in (
             ("wq", d, H * dh, None), ("wk", d, Kv * dh, None),
             ("wv", d, Kv * dh, None), ("wo", H * dh, d, (H * dh) ** -0.5))}
    if cfg.qkv_bias:
        p.update(bq=zeros(H * dh), bk=zeros(Kv * dh), bv=zeros(Kv * dh))
    if cfg.attn_out_bias:
        p["bo"] = zeros(d)
    return p


def init_mlp_params(cfg, L: int, gen: torch.Generator, dev) -> Params:
    """A stacked MLP of width ``cfg.d_ff`` (the reference's
    ``init_mlp_params``): SwiGLU's gate beside w_up for ``act='silu'``,
    zero biases with ``cfg.mlp_bias``."""
    d, ff = cfg.d_model, cfg.d_ff
    p = {}
    if cfg.act == "silu":                    # SwiGLU: a gate beside w_up
        p["w_gate"] = stacked_weight(cfg, L, d, ff, gen, dev)
    p["w_up"] = stacked_weight(cfg, L, d, ff, gen, dev)
    p["w_down"] = stacked_weight(cfg, L, ff, d, gen, dev, ff ** -0.5)
    if cfg.mlp_bias:
        pdt = torch_dtype(cfg.param_dtype)
        p["b_up"] = torch.zeros((L, ff), dtype=pdt, device=dev)
        p["b_down"] = torch.zeros((L, d), dtype=pdt, device=dev)
    return p


def init_lm_params(cfg, seed: int = 0, device: DeviceLike = None) -> Params:
    """Random weights from a seeded ``torch.Generator`` on ``device`` (the
    card by default), with the reference's init distributions.  Each
    stacked leaf is allocated once and filled layer by layer.  Norms
    follow ``cfg.norm`` (no leaves for ``nonparam_ln``); with
    ``cfg.tie_embeddings`` there is no "head" leaf, as in the reference:
    the head is ``embed.T``.  The bias flags add zero biases; layers whose
    ``ffn_kind`` is "moe" hold an "experts" subtree in place of "mlp"
    (``models.moe``); ``cfg.pos == "learned"`` adds a "pos_embed" table.
    The stacked layout needs one FFN kind on every layer, as the
    reference's does."""
    dev = resolve_device(device)
    kinds = {cfg.ffn_kind(i) for i in range(cfg.n_layers)}
    if len(kinds) > 1:
        raise ValueError(f"{cfg.name}: the stacked layer layout needs one "
                         f"FFN kind on every layer, got {sorted(kinds)}")
    gen = param_generator(dev, seed)
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    pdt = torch_dtype(cfg.param_dtype)

    def empty(*shape):
        return torch.empty(shape, dtype=pdt, device=dev)

    layers = {"ln1": init_norm(cfg, (L,), dev),
              "attn": init_attn_params(cfg, L, gen, dev),
              "ln2": init_norm(cfg, (L,), dev)}
    if kinds == {"moe"}:
        layers["experts"] = moe_mod.init_moe_params(cfg, L, gen, dev)
    else:
        layers["mlp"] = init_mlp_params(cfg, L, gen, dev)
    p = {"embed": embed_init_(empty(V, d), gen), "layers": layers,
         "ln_f": init_norm(cfg, (), dev)}
    if not cfg.tie_embeddings:
        p["head"] = embed_init_(empty(d, V), gen)    # the reference's embed.T
    if cfg.pos == "learned":
        p["pos_embed"] = embed_init_(empty(cfg.max_position_learned(), d),
                                     gen)
    return p


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

def learned_positions(table: torch.Tensor, positions: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """Rows ``positions`` of a learned positional table, clamped to its
    last row as in the reference (and a dead lane's -1 to row 0), in
    ``dtype``."""
    return table[torch.clamp(positions.long(), 0, table.shape[0] - 1)
                 ].to(dtype)


def _embed(p: Params, cfg, tokens: torch.Tensor,
           prefix_embeds: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The input stream [B, P + S, d] and its positions: the patch
    embeddings (if any) ahead of the token embeddings, plus the learned
    positions where ``cfg.pos`` says so (the reference's
    ``_embed_inputs``)."""
    x = p["embed"][tokens.long()].to(torch_dtype(cfg.dtype))
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    if cfg.pos == "learned":
        x = x + learned_positions(p["pos_embed"], positions, x.dtype)
    return shard(x, "residual"), positions


def _head(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Final norm and output head; a tied head is a transposed VIEW of the
    embedding (no copy: a captured graph reads the embedding itself), so
    its gradient sums both uses."""
    head = p["embed"].T if cfg.tie_embeddings else p["head"]
    return apply_norm(p["ln_f"], cfg, x) @ head.to(x.dtype)


def _layer_ffn(lp: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """The serving FFN: a MoE layer dispatches without drops
    (``no_drop=True``), so prefill, chunks and decode agree."""
    h = apply_norm(lp["ln2"], cfg, x)
    if "experts" in lp:
        return x + moe_mod.moe_forward(lp["experts"], cfg, h, no_drop=True,
                                       with_aux=False)[0]
    return x + mlp_forward(lp["mlp"], cfg, h)


def _layer_qkv_forward(lp: Params, cfg, x: torch.Tensor,
                       positions: torch.Tensor):
    """Pre-norm block of the training forward: returns (x, the layer's
    MoE aux loss (0 for an MLP layer), its post-RoPE (q, k, v)).  A MoE
    layer drops past the capacity factor, as the reference's training
    forward does."""
    h = apply_norm(lp["ln1"], cfg, x)
    q, k, v = attn.project_qkv(lp["attn"], cfg, h, positions)
    o = attn.causal_attention(q, k, v)
    x = shard(x + attn.output_proj(lp["attn"], o), "residual")
    h = apply_norm(lp["ln2"], cfg, x)
    if "experts" in lp:
        h, aux = moe_mod.moe_forward(lp["experts"], cfg, h)
        aux = aux["moe_load_balance"] + aux["moe_router_z"]
    else:
        h = mlp_forward(lp["mlp"], cfg, h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return shard(x + h, "residual"), aux, (q, k, v)


def _layer_forward(lp: Params, cfg, x: torch.Tensor,
                   positions: torch.Tensor):
    return _layer_qkv_forward(lp, cfg, x, positions)[:2]


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"``: keep the
    outputs of the 2-D matrix products (the weight projections; the
    reference's ``checkpoint_dots_with_no_batch_dims``), recompute the
    rest."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(body, cfg):
    """The layer body under the config's remat: 'full' recomputes the
    whole layer in the backward (saves only its input), 'dots' saves the
    matrix products' outputs and recomputes the rest."""
    if not cfg.remat:
        return body
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_matmuls)
    elif cfg.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    return lambda *args: ckpt.checkpoint(body, *args, use_reentrant=False,
                                         **kw)


def lm_forward_aux(p: Params, cfg, tokens: torch.Tensor,
                   prefix_embeds: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] (after ``prefix_embeds`` [B, P, d], if given) ->
    (logits [B, P + S, V], the MoE layers' summed aux loss (0 without
    experts)).  Differentiable in ``p``; with ``cfg.remat``, under
    autograd, each layer is recomputed in the backward."""
    x, positions = _embed(p, cfg, tokens, prefix_embeds)
    body = _remat(_layer_forward, cfg) if torch.is_grad_enabled() \
        else _layer_forward
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, a = body(layer_params(p, i), cfg, x, positions)
        aux = aux + a
    return shard(_head(p, cfg, x), "logits"), aux


def lm_forward(p: Params, cfg, tokens: torch.Tensor,
               prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, P + S, V] (``lm_forward_aux`` without
    the aux loss)."""
    return lm_forward_aux(p, cfg, tokens, prefix_embeds)[0]


def _logz_gold(logits: torch.Tensor, tokens: torch.Tensor):
    """f32 log-partition and gold logit of each next-token prediction; the
    logits of a prefix ahead of the tokens (a VLM's patch positions) are
    left out."""
    lg = logits[:, logits.shape[1] - tokens.shape[1]:][:, :-1].float()
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, tokens[:, 1:].long()[..., None])[..., 0]
    return logz, gold


def xent_loss(logits: torch.Tensor, tokens: torch.Tensor,
              aux: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss ``ModelApi.loss`` trains on (the reference's
    ``_xent_loss``): mean next-token cross-entropy plus the z-loss
    1e-4·mean(logz²) plus the MoE aux loss ``aux`` (0 when None).
    Returns (loss, {"nll", "aux", "z"})."""
    logz, gold = _logz_gold(logits, tokens)
    nll = (logz - gold).mean()
    zloss = 1e-4 * (logz ** 2).mean()
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return nll + zloss + aux, {"nll": nll, "aux": aux, "z": zloss}


def lm_loss(p: Params, cfg, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy and z-loss of ``batch["tokens"]`` as sums
    over the target positions that ``batch["loss_mask"]`` [B, S] keeps
    (all when absent), divided by their count, plus the MoE aux loss; a
    VLM's ``batch["prefix_embeds"]`` go ahead of the tokens and their
    positions are left out."""
    tokens = batch["tokens"]
    logits, aux = lm_forward_aux(p, cfg, tokens, batch.get("prefix_embeds"))
    logz, gold = _logz_gold(logits, tokens)
    mask = batch.get("loss_mask")
    mask = (torch.ones_like(gold) if mask is None
            else mask[:, 1:].float())
    denom = torch.clamp(mask.sum(), min=1.0)
    nll = ((logz - gold) * mask).sum() / denom
    zloss = 1e-4 * ((logz ** 2) * mask).sum() / denom
    return nll + zloss + aux, {"nll": nll, "aux": aux, "z": zloss}


# ---------------------------------------------------------------------------
# SWAN calibration + absorption
# ---------------------------------------------------------------------------

@torch.no_grad()
def collect_qkv(p: Params, cfg, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None):
    """Run the model, capturing per-layer post-RoPE q/k and v (§4.1.1).
    The layers run as in training (MoE layers drop past capacity), as in
    the reference; a VLM's prefix positions are captured too.

    Returns (q [L,B,S,H,dh], k [L,B,S,Kv,dh], v [L,B,S,Kv,dh], wo [L,H·dh,d])."""
    x, positions = _embed(p, cfg, tokens, prefix_embeds)
    qs, ks, vs = [], [], []
    for i in range(cfg.n_layers):
        x, _, (q, k, v) = _layer_qkv_forward(layer_params(p, i), cfg, x,
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


def init_paged_caches(cfg, swan, batch: int, max_seq: int, n_pages: int,
                      page_size: int, device: DeviceLike = None) -> Params:
    """Paged serve state: the sparse sides become a shared page pool
    [L, n_pages, Kv, page_size, k]; the dense rings stay per slot.  The
    page table is a separate operand (host-owned, ``runtime.page_pool``)."""
    if swan is None or not swan.enabled:
        raise ValueError("paged caches require SWAN (the sparse sides are "
                         "what gets paged); use init_caches for dense")
    if max_seq % page_size:
        raise ValueError(f"max_seq={max_seq} not divisible by "
                         f"page_size={page_size}")
    dev = resolve_device(device)
    L, Kv, dh, b = cfg.n_layers, cfg.n_kv_heads, cfg.d_head, swan.buffer
    cdt = torch_dtype(cfg.dtype)
    return {"pool": pc.init_paged_pool(cfg, swan, n_pages, page_size, dev,
                                       lead=(L,)),
            "buf_k": torch.zeros((L, batch, Kv, b, dh), dtype=cdt, device=dev),
            "buf_v": torch.zeros((L, batch, Kv, b, dh), dtype=cdt, device=dev),
            "buf_pos": torch.full((L, batch, b), -1, dtype=torch.int32,
                                  device=dev)}


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


def _swan_seq_ctx():
    """(mesh, seq_axis) for split-S SWAN decode, from the installed rules'
    ``swan_sparse`` spec (its sequence dim); (None, None) without rules."""
    rules = current_rules()
    if rules is None:
        return None, None
    spec = rules.spec("swan_sparse")
    if spec is None or len(spec) < 3 or spec[2] is None:
        return None, None
    return rules.mesh, spec[2]


def _swan_layer_decode(lp: Params, p_qk_l: torch.Tensor, cache_l: Params,
                       cfg, swan, x: torch.Tensor, pos: torch.Tensor,
                       k_act, page_tab: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """One layer's SWAN decode: insert into the hybrid cache (in place; the
    slab, or the pool through ``page_tab``), then read it — through a CUDA
    kernel when the cache is on the card, through the plain gather/scatter
    path otherwise.  Rules that split the sparse cache's sequence over a
    mesh axis (``_swan_seq_ctx``) run the plain read split-S; a cache on
    the card still goes through the kernel, which is split-S over the
    sequence itself: the mesh is one device, so the split changes where
    nothing lives."""
    B = x.shape[0]
    Kv, G, dh = cfg.n_kv_heads, cfg.q_group, cfg.d_head
    q, k, v = attn.project_qkv(lp["attn"], cfg, x, pos[:, None])
    q_hat = rotate_q(q, p_qk_l, Kv)[:, 0]                        # [B,Kv,G,dh]
    k_hat = rotate_k(k, p_qk_l)                                  # [B,1,Kv,dh]
    mesh, seq_axis = _swan_seq_ctx()
    if page_tab is None:
        hc.swan_cache_insert_decode_(cache_l, swan, k_hat, v, pos, k_act=k_act)
        if kernel_supported(swan, cache_l["k"]["vals"]):
            o = swan_decode_from_cache(q_hat, cache_l, swan, pos)
        else:
            o = swa.swan_decode_attention(q_hat, cache_l, swan, pos,
                                          mesh=mesh, seq_axis=seq_axis)
    else:
        pc.paged_insert_decode_(cache_l, swan, k_hat, v, pos, page_tab,
                                k_act=k_act)
        if kernel_supported(swan, cache_l["pool"]["k"]["vals"], page_tab):
            o = swan_decode_paged_from_cache(q_hat, cache_l, swan, pos,
                                             page_tab)
        else:
            o = swa.swan_decode_attention_paged(q_hat, cache_l, swan, pos,
                                                page_tab, mesh=mesh,
                                                seq_axis=seq_axis)
    return attn.output_proj(lp["attn"], o.reshape(B, 1, Kv * G, dh))


def _swan_layer_prefill(lp: Params, p_qk_l, cache_l: Params, cfg, swan,
                        x: torch.Tensor, positions, k_act,
                        true_len: Optional[int] = None) -> torch.Tensor:
    """Prefill: dense (lossless, Lemma A.1) attention on rotated q̂/k̂/v̂;
    the hybrid cache is filled (in place) for the decode steps."""
    B, S, _ = x.shape
    Kv, G, dh = cfg.n_kv_heads, cfg.q_group, cfg.d_head
    q, k, v = attn.project_qkv(lp["attn"], cfg, x, positions)
    q_hat = rotate_q(q, p_qk_l, Kv).reshape(B, S, Kv * G, dh)
    k_hat = rotate_k(k, p_qk_l)
    hc.swan_cache_insert_prefill_(cache_l, swan, k_hat, v, k_act=k_act,
                                  true_len=true_len)
    return attn.output_proj(lp["attn"], attn.causal_attention(q_hat, k_hat, v))


@torch.no_grad()
def lm_prefill(p: Params, cfg, tokens: torch.Tensor, caches: Params,
               swan=None, projections: Optional[Params] = None,
               prefix_embeds: Optional[torch.Tensor] = None,
               k_active: Optional[int] = None, true_len: Optional[int] = None
               ) -> Tuple[torch.Tensor, Params]:
    """Process the prompt [B, S] (after ``prefix_embeds`` [B, P, d], if
    given: the cache then holds P + S positions), filling ``caches`` in
    place.  Returns (last-token logits [B, 1, V], caches).

    ``k_active`` (an int, or a 0-d device tensor) caps the SWAN retention
    of the whole prompt (per-request k).  ``true_len`` (an int, or a 0-d
    device tensor) is the real prompt length when ``tokens`` is padded to
    a bucket: the logits are taken at true_len - 1 (a device gather) and
    the ring is anchored there."""
    x, positions = _embed(p, cfg, tokens, prefix_embeds)
    use_swan = swan is not None and swan.enabled
    k_layers = _k_per_layer(cfg, swan, projections) if use_swan else None
    if use_swan and k_active is not None:
        k_layers = [torch.clamp(k_active, max=k)
                    if isinstance(k_active, torch.Tensor)
                    else min(k, int(k_active)) for k in k_layers]
    for i in range(cfg.n_layers):
        lp, cache_l = layer_params(p, i), layer_cache(caches, i)
        h = apply_norm(lp["ln1"], cfg, x)
        if use_swan:
            h = _swan_layer_prefill(lp, projections["p_qk"][i], cache_l, cfg,
                                    swan, h, positions, k_layers[i],
                                    true_len=true_len)
        else:
            q, k, v = attn.project_qkv(lp["attn"], cfg, h, positions)
            attn.dense_cache_insert_(cache_l, k, v, 0)
            h = attn.output_proj(lp["attn"], attn.causal_attention(q, k, v))
        x = shard(x + h, "residual")
        x = shard(_layer_ffn(lp, cfg, x), "residual")
    if true_len is None:
        x = x[:, -1:]
    elif isinstance(true_len, torch.Tensor):
        x = x.index_select(1, (true_len.long() - 1).reshape(1))
    else:
        x = x[:, int(true_len) - 1:int(true_len)]
    return _head(p, cfg, x), caches


def _swan_layer_prefill_chunk(lp: Params, p_qk_l, cache_l: Params, cfg, swan,
                              x: torch.Tensor, lanes, positions, k_act,
                              page_tab: Optional[torch.Tensor] = None,
                              prefix_len: Optional[int] = None
                              ) -> torch.Tensor:
    """One layer of BATCHED chunked prefill against the batched serve
    state: gather the P lanes' rings (and slab rows), attend each lane to
    its [winnowed sparse prefix ‖ ring ‖ chunk], commit each chunk at its
    own offset, and write the live lanes' rings back.  Dead lanes (``slot
    >= n_slots``) read a clamped lane and write nothing: slab rows and
    rings take fixed-shape masked writes (``hc.lane_writes``), paged
    writes of dead lanes go to the trash page."""
    Kv = cfg.n_kv_heads
    q, k, v = attn.project_qkv(lp["attn"], cfg, x, positions)
    q_hat = rotate_q(q, p_qk_l, Kv)                      # [P,S,Kv,G,dh]
    k_hat = rotate_k(k, p_qk_l)
    lane_ix, start, true_len = lanes["lane_ix"], lanes["start"], lanes["true_len"]
    ring = {n: cache_l[n][lane_ix] for n in ("buf_k", "buf_v", "buf_pos")}
    sp_len = torch.clamp(start - swan.buffer, min=0).int()
    if page_tab is None:                                 # slab layout
        view = dict(ring)
        S_slab = cache_l["k"]["vals"].shape[2]
        pl = S_slab if prefix_len is None else min(prefix_len, S_slab)
        for n in ("k", "v"):
            # a power-of-two prefix of the slab rows: the read follows the
            # prompts so far, not max_seq
            view[n] = {m: x_[:, :, :pl][lane_ix]
                       for m, x_ in cache_l[n].items()}
        stats = (chunk_stats_from_view(q_hat, view, sp_len)
                 if kernel_supported(swan, view["k"]["vals"]) else None)
        o = swa.swan_chunk_prefill_attention(q_hat, k_hat, v, view, swan,
                                             start, sparse_stats=stats)
        _, packed_k, packed_v, upd = hc.chunk_evict_winnow(
            ring, swan, k_hat, v, start, true_len, k_act=k_act)
        ring_new = {**ring, **upd}                       # upd is {} at b == 0
        hc.write_sparse_rows_(cache_l["k"], packed_k, plan=lanes["rows"])
        hc.write_sparse_rows_(cache_l["v"], packed_v, plan=lanes["rows"])
    else:                                                # paged layout
        page_rows = page_tab[lane_ix]                    # [P, Pg]
        lane = dict(ring)
        lane["pool"] = cache_l["pool"]
        if kernel_supported(swan, cache_l["pool"]["k"]["vals"], page_rows):
            # pool pages feed the kernel directly: no logical view
            stats = chunk_stats_from_pool(q_hat, cache_l["pool"], sp_len,
                                          page_rows)
            o = swa.swan_chunk_prefill_attention(q_hat, k_hat, v, ring, swan,
                                                 start, sparse_stats=stats)
        else:
            o = swa.swan_chunk_prefill_attention(
                q_hat, k_hat, v, swa.paged_logical_view(lane, page_rows),
                swan, start)
        pc.paged_insert_prefill_chunk_(lane, swan, k_hat, v, start, true_len,
                                       page_rows, k_act=k_act,
                                       dead=lanes["dead"])
        ring_new = {n: lane[n] for n in ("buf_k", "buf_v", "buf_pos")}
    for n in ("buf_k", "buf_v", "buf_pos"):
        hc.apply_lane_writes_(cache_l[n], ring_new[n], lanes["ring"])
    return attn.output_proj(lp["attn"], o)


def _dense_layer_prefill_chunk(lp: Params, cache_l: Params, cfg,
                               x: torch.Tensor, lanes, positions,
                               prefix_len: Optional[int] = None
                               ) -> torch.Tensor:
    """Batched chunked prefill for the dense-cache baseline: insert each
    live lane's chunk K/V at [start_p, start_p + S) of its slot, then causal
    attention of each chunk against its lane's first ``prefix_len`` rows
    (rows past a lane's chunk are masked by its causal offset)."""
    q, k, v = attn.project_qkv(lp["attn"], cfg, x, positions)
    attn.dense_cache_insert_rows_(cache_l, k, v, lanes["rows"])
    S_max = cache_l["k"].shape[2]
    pl = S_max if prefix_len is None else min(prefix_len, S_max)
    kc = cache_l["k"][:, :, :pl][lanes["lane_ix"]].transpose(1, 2)
    vc = cache_l["v"][:, :, :pl][lanes["lane_ix"]].transpose(1, 2)
    if kc.shape[1] > attn.DENSE_ATTN_MAX_SEQ:
        o = attn.blocked_attention(q, kc, vc, causal=True,
                                   q_offset=lanes["start"])
    else:
        o = attn.dense_attention(q, kc, vc, causal=True,
                                 q_offset=lanes["start"])
    return attn.output_proj(lp["attn"], o)


@torch.no_grad()
def lm_prefill_chunk_batched(p: Params, cfg, tokens: torch.Tensor,
                             caches: Params, slot, start, swan=None,
                             projections: Optional[Params] = None,
                             k_active=None, true_len=None,
                             page_tab: Optional[torch.Tensor] = None,
                             prefix_len: Optional[int] = None
                             ) -> Tuple[torch.Tensor, Params]:
    """Advance up to P slots' prefills by one chunk EACH against the
    engine's batched serve state (batched concurrent chunked prefill),
    updating ``caches`` in place.

    ``tokens [P, C]``: the chunks, one lane per in-flight prefill, padded
    to a common width.  ``slot`` / ``start`` / ``true_len`` / ``k_active``
    are per-lane [P] operands (device tensors, or host arrays that are
    copied over): each lane's slot, the position of its chunk's first
    token, its number of real chunk tokens and its retention cap.  Lanes
    with ``slot >= n_slots`` are DEAD padding: they compute clamped
    garbage and write nothing that a live lane can see.  No value is read
    back to the host and every shape follows (P, C, prefix) alone, so
    the dispatch can be captured in a CUDA graph.  With SWAN, each lane
    sees positions [0, start) exactly as a decode step at that position
    would (winnowed sparse prefix + dense ring), and after the chunk the
    ring holds [start + true_len - b, start + true_len).  ``page_tab
    [n_slots, Pg]`` (a table prefix) routes the sparse reads and writes
    through the page pool; ``prefix_len`` (python int >= max(start) + C)
    bounds the slab/dense read.

    Returns (logits at each chunk's last real token [P, V], caches); dead
    lanes' logits are garbage the caller discards."""
    P, S = tokens.shape
    dev = tokens.device
    use_swan = swan is not None and swan.enabled
    if page_tab is not None and not use_swan:
        raise ValueError("page_tab given but SWAN disabled — only the "
                         "sparse sides are paged")
    n_slots = (caches["buf_pos"] if use_swan else caches["k"]).shape[1]

    def lane_vec(x):
        return torch.as_tensor(x, device=dev).long().reshape(-1).expand(P)

    slot = lane_vec(slot)
    start = lane_vec(start)
    lanes = {
        "slot": slot, "start": start,
        "dest": torch.clamp(start - (swan.buffer if use_swan else 0), min=0),
        "lane_ix": torch.clamp(slot, max=n_slots - 1),
        "true_len": (torch.full((P,), S, dtype=torch.long, device=dev)
                     if true_len is None else lane_vec(true_len)),
        "dead": slot >= n_slots,
    }
    # the fixed-shape slab/dense row commits and ring write-backs, planned
    # once for every layer (``hc.lane_writes``)
    if use_swan:
        lanes["ring"] = hc.lane_writes(slot, n_slots)
        if page_tab is None:
            lanes["rows"] = hc.lane_writes(slot, n_slots, lanes["dest"], S,
                                           caches["k"]["vals"].shape[3])
    else:
        lanes["rows"] = hc.lane_writes(slot, n_slots, start, S,
                                       caches["k"].shape[3])
    x = p["embed"][tokens.long()].to(torch_dtype(cfg.dtype))
    positions = lanes["start"][:, None] + torch.arange(S, device=dev)[None]
    if cfg.pos == "learned":
        x = x + learned_positions(p["pos_embed"], positions, x.dtype)
    x = shard(x, "residual")
    k_layers = _k_per_layer(cfg, swan, projections) if use_swan else None
    k_req = None if k_active is None else lane_vec(k_active)
    for i in range(cfg.n_layers):
        lp, cache_l = layer_params(p, i), layer_cache(caches, i)
        h = apply_norm(lp["ln1"], cfg, x)
        if use_swan:
            k_eff = (k_layers[i] if k_req is None
                     else torch.clamp(k_req, max=k_layers[i]))
            h = _swan_layer_prefill_chunk(
                lp, projections["p_qk"][i], cache_l, cfg, swan, h, lanes,
                positions, k_eff, page_tab=page_tab, prefix_len=prefix_len)
        else:
            h = _dense_layer_prefill_chunk(lp, cache_l, cfg, h, lanes,
                                           positions, prefix_len=prefix_len)
        x = shard(x + h, "residual")
        x = shard(_layer_ffn(lp, cfg, x), "residual")
    last = torch.clamp(lanes["true_len"] - 1, min=0)
    x = x[torch.arange(P, device=dev), last][:, None]      # last REAL token
    return _head(p, cfg, x)[:, 0], caches


@torch.no_grad()
def lm_decode_step(p: Params, cfg, token: torch.Tensor, pos, caches: Params,
                   swan=None, projections: Optional[Params] = None,
                   k_active=None, page_tab: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Params]:
    """token [B] -> (logits [B, V], caches updated in place).  ``pos`` is a
    python int (lockstep batch) or a per-sequence [B] tensor; lanes with
    pos < 0 are dead (free or mid-prefill slots: nothing of theirs
    changes).  ``k_active``: a python int or per-sequence [B] retention
    cap (per-request k).  ``page_tab [B, Pg]``: ``caches`` is the paged
    layout (``init_paged_caches``) and sparse reads and writes go through
    the shared page pool."""
    B = token.shape[0]
    x = p["embed"][token.long()[:, None]].to(torch_dtype(cfg.dtype))
    pos = hc.per_seq_pos(pos, B, x.device)
    if cfg.pos == "learned":
        x = x + learned_positions(p["pos_embed"], pos[:, None], x.dtype)
    use_swan = swan is not None and swan.enabled
    if page_tab is not None and not use_swan:
        raise ValueError("page_tab given but SWAN disabled — only the "
                         "sparse sides are paged")
    k_layers = _k_per_layer(cfg, swan, projections) if use_swan else None
    k_req = (None if k_active is None or isinstance(k_active, int)
             else torch.as_tensor(k_active, device=x.device))
    for i in range(cfg.n_layers):
        lp, cache_l = layer_params(p, i), layer_cache(caches, i)
        h = apply_norm(lp["ln1"], cfg, x)
        if use_swan:
            k_eff = k_layers[i]
            if isinstance(k_active, int):
                k_eff = min(k_eff, k_active)
            elif k_req is not None:
                k_eff = torch.clamp(k_req, max=k_eff)
            h = _swan_layer_decode(lp, projections["p_qk"][i], cache_l, cfg,
                                   swan, h, pos, k_eff, page_tab=page_tab)
        else:
            h, _ = attn.attn_decode_dense(lp["attn"], cfg, h, pos, cache_l)
        x = _layer_ffn(lp, cfg, x + h)
    return _head(p, cfg, x)[:, 0], caches
