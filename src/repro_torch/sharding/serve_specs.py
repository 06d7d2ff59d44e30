"""PartitionSpecs for serving state (KV caches, SWAN hybrid caches, page
pools, recurrent states) and serve-step inputs (port of
``repro.sharding.serve_specs``, less the ``NamedSharding`` builders).

Caches shard the batch over ('pod', 'data') and the sequence dim over
'model' (split-S decode, valid for any head count and batch); axes a dim
doesn't divide, or that the mesh doesn't carry, are dropped by the
sanitizer.  Every serve-state leaf must have an explicit rule here: an
unknown leaf would ship replicated, which on a data mesh means every shard
carries and writes the whole array.  ``unspecced_serve_leaves`` names the
leaves that would fall through, so tests can hold every state the engine
builds to completeness."""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.sharding.api import P, PartitionSpec
from repro_torch.sharding.specs import dp_axes
from repro_torch.tree import flatten_with_path, tree_map, unflatten

# Every serve-state leaf name with an explicit rule in ``_leaf_spec_raw``.
# swanlint's SWAN104 (``repro_torch.analysis.lint``) reads this tuple
# statically and holds the leaf keys the cache and state initialisers
# build to it, so a new leaf cannot land without a sharding decision.
KNOWN_LEAF_NAMES = ("vals", "idx", "scale", "k", "v", "buf_k", "buf_v",
                    "buf_pos", "h", "conv", "S", "x_tm", "x_cm")


def _sanitize(spec: PartitionSpec, shape: Tuple[int, ...], mesh
              ) -> PartitionSpec:
    """Drop sharding on axes the mesh doesn't carry or that don't divide
    the dim size."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            out.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        if any(a not in mesh.shape for a in axes):
            out.append(None)
            continue
        n = int(np.prod([mesh.shape[a] for a in axes]))
        out.append(ax if (dim % n == 0 and dim >= n) else None)
    return P(*out)


def sanitize_tree(specs, tree, mesh):
    return tree_map(lambda s, x: _sanitize(s, tuple(x.shape), mesh), specs,
                    tree)


def _leaf_spec_raw(name: str, ndim: int) -> Optional[PartitionSpec]:
    """Spec of a serve-state leaf by path name over the production axis
    names ('pod'/'data' for batch-like dims, 'model' for sequence-like
    dims); None for a leaf without a rule."""
    dp = ("pod", "data")
    leaf = name.split("/")[-1]
    if leaf not in KNOWN_LEAF_NAMES:
        return None
    # stacked states lead with a layer or group axis (never sharded)
    if "pool/" in name:
        # the pool [L, n_pages, Kv, ps, k]: pages play the slab's batch
        # role (a page belongs to one slot, a slot to one data shard) and
        # page rows the sequence's
        if leaf in ("vals", "idx"):
            return P(None, dp, None, "model", None)
        if leaf == "scale":              # [L, n_pages, Kv, ps]
            return P(None, dp, None, "model")
    if leaf in ("vals", "idx"):          # [L, B, Kv, S, k] packed sparse
        return P(None, dp, None, "model", None)
    if leaf == "scale":                  # [L, B, Kv, S]
        return P(None, dp, None, "model")
    if leaf in ("k", "v"):               # [L, B, Kv, S, dh] dense cache
        return P(None, dp, None, "model", None)
    if leaf in ("buf_k", "buf_v"):       # [L, B, Kv, b, dh] ring
        return P(None, dp, None, None, None)
    if leaf == "buf_pos":                # [L, B, b]
        return P(None, dp, None)
    if leaf == "h":                      # mamba state [G, B, d_in, N]
        return P(None, dp, "model", None)
    if leaf == "conv":                   # mamba conv tail [G, B, c, d_in]
        return P(None, dp, None, "model")
    if leaf == "S":                      # rwkv state [L, B, H, dk, dv]
        return P(None, dp, None, None, None)
    if leaf in ("x_tm", "x_cm"):         # rwkv shifts [L, B, 1, d]
        return P(None, dp, None, None)
    return None


def _leaf_spec(name: str, ndim: int, mesh) -> PartitionSpec:
    spec = _leaf_spec_raw(name, ndim)
    if spec is None:
        return P(*([None] * ndim))
    # the production dp tuple collapsed to what this mesh carries
    dp = dp_axes(mesh)
    return P(*[dp if ax == ("pod", "data") else ax for ax in spec])


def unspecced_serve_leaves(state) -> List[str]:
    """Paths of serve-state leaves without an explicit rule."""
    return [name for name, leaf in flatten_with_path(state)
            if _leaf_spec_raw(name, leaf.ndim) is None]


def serve_state_pspecs(state, mesh):
    """A tree of specs shaped as ``state``."""
    return unflatten(state, [
        _sanitize(_leaf_spec(name, leaf.ndim, mesh), tuple(leaf.shape), mesh)
        for name, leaf in flatten_with_path(state)])


def batch_pspecs(batch, mesh):
    """Every input leaf batch-sharded over the data axes."""
    dp = dp_axes(mesh)
    return tree_map(lambda x: _sanitize(P(dp, *([None] * (x.ndim - 1))),
                                        tuple(x.shape), mesh), batch)
