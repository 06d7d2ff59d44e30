"""PartitionSpec rules for parameters and activations (port of
``repro.sharding.specs``, less ``params_shardings``, which needs a device
mesh).

Two tensor-parallel styles (``ModelConfig.tp_style``):

  * ``heads``       — attention heads / FFN hidden / vocab over 'model';
                      optional FSDP over 'data' (``fsdp_data``) for the
                      405B-class configs; optional sequence sharding of the
                      residual stream over 'model' (``seq_shard``).
  * ``fsdp_model``  — archs whose head counts don't divide the mesh
                      (whisper-small 12 heads, internvl2-1b 14): the
                      'model' axis stores each parameter sharded on its
                      largest dim; activations stay batch-sharded.

Data parallelism spans ('pod', 'data') when the mesh has a pod axis.
Parameter specs are resolved by leaf path name, so one table covers every
arch; stacked [L, ...] leaves get their leading axes unsharded (a spec is
matched to the trailing dims).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.sharding.api import P, PartitionSpec, ShardingRules
from repro_torch.tree import flatten_with_path, unflatten


def dp_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

# leaf name -> spec over the leaf's TRAILING dims ("heads" style); "D"
# marks where the fsdp_data axis goes ('data' when enabled)
_HEADS_TABLE = {
    "embed":      ("model", "D"),
    "pos_embed":  (None, "D"),
    "head":       ("D", "model"),
    "wq":         ("D", "model"),
    "wk":         ("D", "model"),
    "wv":         ("D", "model"),
    "wo":         ("model", "D"),
    "bq":         ("model",),
    "bk":         ("model",),
    "bv":         ("model",),
    "bo":         (None,),
    "w_gate":     ("D", "model"),
    "w_up":       ("D", "model"),
    "w_down":     ("model", "D"),
    "b_up":       ("model",),
    "b_down":     (None,),
    "router":     (None, None),
    "scale":      (None,),
    "bias":       (None,),
    # mamba
    "w_in":       ("D", "model"),
    "conv_w":     (None, "model"),
    "conv_b":     ("model",),
    "w_x":        ("model", "D"),
    "w_dt":       ("D", "model"),
    "dt_bias":    ("model",),
    "a_log":      ("model", None),
    "d_skip":     ("model",),
    "w_out":      ("model", "D"),
    # rwkv
    "w_r":        ("D", "model"),
    "w_k6":       ("D", "model"),
    "w_v6":       ("D", "model"),
    "w_g":        ("D", "model"),
    "w_o6":       ("model", "D"),
    "decay_w":    ("model",),
    "bonus_u":    ("model",),
    "mix":        (None, None),
    "decay_lora_a": ("D", None),
    "decay_lora_b": (None, "model"),
}

# MoE expert tensors (leading E axis): expert parallelism ('model' on E)
# with ``moe.shard_experts``, else TP on the expert-hidden dim
_MOE_EP = {
    "w_gate": ("model", "D", None),
    "w_up":   ("model", "D", None),
    "w_down": ("model", None, "D"),
}
_MOE_TP = {
    "w_gate": (None, "D", "model"),
    "w_up":   (None, "D", "model"),
    "w_down": (None, "model", "D"),
}


def _n_devices(mesh, ax) -> int:
    return int(np.prod([mesh.shape[a]
                        for a in ((ax,) if isinstance(ax, str) else ax)]))


def _leaf_spec(path: str, shape: Tuple[int, ...], cfg, mesh) -> PartitionSpec:
    names = path.split("/")
    leaf = names[-1]
    if cfg.tp_style == "fsdp_model":
        # storage only: the largest dim over 'model' where it divides
        if len(shape) == 0:
            return P()
        big = int(np.argmax(list(shape)))
        axes = [None] * len(shape)
        n = mesh.shape["model"]
        if shape[big] % n == 0 and shape[big] >= n:
            axes[big] = "model"
        return P(*axes)
    if "experts" in names and leaf in _MOE_EP:
        entry = (_MOE_EP if cfg.moe.shard_experts else _MOE_TP)[leaf]
    else:
        entry = _HEADS_TABLE.get(leaf)
        if entry is None:
            return P(*([None] * len(shape)))
    spec = [("data" if cfg.fsdp_data else None) if ax == "D" else ax
            for ax in entry]
    while len(spec) < len(shape):          # stacked leading axes
        spec.insert(0, None)
    spec = spec[-len(shape):] if len(spec) > len(shape) else spec
    # keep only shardings that divide their dim (clean tiles)
    return P(*[None if ax is None or dim % _n_devices(mesh, ax) else ax
               for dim, ax in zip(shape, spec)])


def params_pspecs(params, cfg, mesh):
    """A tree of specs shaped as ``params`` (any leaves with ``.shape``:
    tensors on the ``meta`` device cost nothing at full width)."""
    flat = flatten_with_path(params)
    return unflatten(params, [_leaf_spec(path, tuple(leaf.shape), cfg, mesh)
                              for path, leaf in flat])


# ---------------------------------------------------------------------------
# Activation rules
# ---------------------------------------------------------------------------

def activation_rules(cfg, mesh) -> ShardingRules:
    dp = dp_axes(mesh)
    tp_ok = cfg.tp_style == "heads"
    n_model = mesh.shape["model"]
    seq = "model" if (cfg.seq_shard and tp_ok) else None
    heads_ax = "model" if (tp_ok and (cfg.n_heads * cfg.d_head) % n_model == 0
                           and cfg.n_heads % n_model == 0) else None
    ff_ax = "model" if (tp_ok and cfg.d_ff % n_model == 0) else None
    kinds: Dict[str, PartitionSpec] = {
        "tokens":     P(dp, None),
        "residual":   P(dp, seq, None),
        # seq-sharded archs keep logits sharded on seq; otherwise vocab-TP
        "logits":     (P(dp, seq, None) if seq
                       else P(dp, None, "model" if tp_ok else None)),
        "attn_q":     P(dp, None, heads_ax, None),
        "attn_kv":    P(dp, None, None, None),
        "attn_out":   P(dp, None, heads_ax, None),
        "ffn_hidden": P(dp, None, ff_ax),
        # decode: the cache's sequence dim over 'model' (split-S, any head
        # count)
        "kv_cache":   P(dp, None, "model", None),
        "swan_sparse": P(dp, None, "model", None),
        "swan_scale": P(dp, None, "model"),
        "swan_buf":   P(dp, None, None, None),
        "decode_q":   P(dp, None, None, None),
        # mamba: channel parallel
        "mamba_inner": P(dp, None, "model" if tp_ok else None),
        "mamba_state": P(dp, "model" if tp_ok else None, None),
        "rwkv_state": P(dp, None, None, None),
        "moe_buffer": P("model" if (cfg.moe and cfg.moe.shard_experts)
                        else None, None, None),
        "prefix":     P(dp, None, None),
        "enc_out":    P(dp, None, None),
    }
    return ShardingRules(mesh, kinds)
