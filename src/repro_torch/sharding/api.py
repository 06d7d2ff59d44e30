"""Partition specs and the activation-rules context (port of
``repro.sharding.api``, less ``shard`` and ``shard_map_compat``, which
need a device mesh).

A :class:`PartitionSpec` is a tuple with one entry per dim: an axis name,
a tuple of axis names, or ``None`` (unsharded), kept in jax's canonical
form (a one-name tuple is the name), so ``tuple(spec)`` equals
``tuple(jax.sharding.PartitionSpec(...))`` of the same entries.  A mesh is
anything with ``.shape`` (axis -> size) and ``.axis_names``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Optional

_state = threading.local()


def _canonical(entry):
    """An entry as jax keeps it: a one-name tuple is the name, an empty
    one None."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


class PartitionSpec(tuple):
    """``P("data", None, ("pod", "data"))``: one entry per dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class ShardingRules:
    """Activation kinds -> specs over one mesh."""

    def __init__(self, mesh, kinds: Dict[str, PartitionSpec]):
        self.mesh = mesh
        self.kinds = kinds

    def spec(self, kind: str) -> Optional[PartitionSpec]:
        return self.kinds.get(kind)


def current_rules() -> Optional[ShardingRules]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]) -> Iterator[None]:
    prev = current_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev
