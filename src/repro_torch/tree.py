"""Nested-dict parameter trees: flatten, map and rebuild in JAX's order.

``jax.tree_util`` flattens a dict by its SORTED keys at every level and
names a leaf by its ``/``-joined keys; the optimizer's decay mask and the
checkpointer's leaf order follow that convention, so a checkpoint written
by either package restores in the other.  Anything but a dict is a
leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Tree = Any


def flatten_with_path(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in JAX's flatten order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_path(tree[k], f"{prefix}/{k}" if prefix
                                     else str(k))
        return out
    return [(prefix, tree)]


def leaves(tree: Tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like: Tree, new_leaves: List[Any]) -> Tree:
    """A tree shaped as ``like`` whose leaves, in flatten order, are
    ``new_leaves``."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}   # leaves in order
            return {k: built[k] for k in t}               # like's key order
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), keeping ``tree``'s nesting."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves(tree))])
