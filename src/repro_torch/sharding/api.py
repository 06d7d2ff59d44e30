"""Partition specs, the activation-rules context and the serve engine's
data-parallel layout on one device (port of ``repro.sharding.api``, less
``shard``: no model code of the port calls an activation hook).

A :class:`PartitionSpec` is a tuple with one entry per dim: an axis name,
a tuple of axis names, or ``None`` (unsharded), kept in jax's canonical
form (a one-name tuple is the name), so ``tuple(spec)`` equals
``tuple(jax.sharding.PartitionSpec(...))`` of the same entries.  A mesh is
anything with ``.shape`` (axis -> size) and ``.axis_names``
(``repro_torch.launch.mesh``).

:func:`shard_map_compat` is the counterpart of the reference's
``shard_map`` wrapper for a mesh laid over ONE device
(:class:`ShardLayout`): the serve state stays one tensor per leaf with
its data axis shard-major, the host ships the reference's shard-local
operands, and the wrapper turns them into the device's rows before the
single-device body runs once over every shard.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Iterator, Optional, Sequence

import torch

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


# ---------------------------------------------------------------------------
# Data-parallel shards on one device
# ---------------------------------------------------------------------------

def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:0`` name one card (the current one is 0)."""
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def one_device(mesh, device=None) -> torch.device:
    """The one device every shard of ``mesh`` lives on (``device``, when
    given, must be it).  A ``meta`` mesh (``make_production_mesh``) is
    refused, and a mesh over distinct devices raises
    ``NotImplementedError``: their placement is ROADMAP item A.3's open
    part, waiting on a machine with more than one card."""
    devs = getattr(mesh, "devices", None)
    if devs is None:
        raise ValueError("the mesh has no devices — build it with "
                         "repro_torch.launch.mesh")
    uniq = {torch.device(d) for d in getattr(devs, "flat", devs)}
    if any(d.type == "meta" for d in uniq):
        raise ValueError("a mesh of meta placeholders (make_production_"
                         "mesh) runs nothing")
    one = next(iter(uniq))
    if any(not _same_device(one, d) for d in uniq):
        raise NotImplementedError(
            f"a mesh over distinct devices {sorted(map(str, uniq))}: "
            "multi-card placement is ROADMAP A.3's open item; lay the mesh "
            "over one device (devices=[dev] * N)")
    if device is not None and not _same_device(torch.device(device), one):
        raise ValueError(f"device={device} but the mesh lives on {one}")
    return one


def dp_index(n_rows: int, dp: int, device=None) -> torch.Tensor:
    """The data shard of each row of a shard-major axis of ``n_rows`` rows
    in ``dp`` equal blocks: the one-device counterpart of the reference
    engine's ``_dp_index`` (a device's linear index along the data axes
    inside ``shard_map``)."""
    return torch.arange(n_rows, device=device) // (n_rows // dp)


class ShardLayout:
    """``dp`` data shards of a serve state laid out shard-major on one
    device: shard ``s`` owns lanes ``[s*n_local, (s+1)*n_local)`` of every
    batched leaf and, paged, pool pages ``[s*pages_per_shard,
    (s+1)*pages_per_shard)``, its local page 0 the shard's trash page.
    ``pages_per_shard`` follows the pool (the engine updates it when the
    pool grows)."""

    def __init__(self, dp: int, n_local: int, pages_per_shard: int = 0):
        self.dp = dp
        self.n_local = n_local
        self.n_slots = dp * n_local
        self.pages_per_shard = pages_per_shard

    def check_specs(self, state, specs) -> None:
        """Hold a serve state's data-only ``specs`` (a tree like ``state``)
        to this layout: a leaf split over the data axes is split along one
        dim, of ``n_slots`` lanes or ``dp * pages_per_shard`` pool pages,
        which this layout lays out shard-major; a leaf whose spec names no
        axis is whole on every shard.  Raises ``ValueError`` otherwise."""
        if isinstance(state, dict):
            for name, x in state.items():
                self.check_specs(x, specs[name])
            return
        dims = [d for d, ax in enumerate(tuple(specs)) if ax is not None]
        sizes = {self.n_slots, self.dp * self.pages_per_shard}
        if dims and (len(dims) > 1 or state.shape[dims[0]] not in sizes):
            raise ValueError(
                f"a leaf of shape {tuple(state.shape)} with spec {specs}: "
                f"the shard-major layout splits one dim of {sorted(sizes)}")

    def lanes(self, local: torch.Tensor) -> torch.Tensor:
        """Shard-local lane indices laid out ``[dp, P]`` (a lane parked at
        ``n_local`` is off its shard) -> the device's lanes (parked at
        ``n_slots``, where every write drops)."""
        local = local.long()
        sh = dp_index(local.shape[0], self.dp, local.device)
        return torch.where(local < self.n_local, local + sh * self.n_local,
                           torch.full_like(local, self.n_slots))

    def pages(self, tab: torch.Tensor) -> torch.Tensor:
        """A page table ``[n_slots, W]`` of shard-local page indices (row
        ``r`` on shard ``r // n_local``) -> the device's pool pages."""
        sh = dp_index(tab.shape[0], self.dp, tab.device)
        return tab + (sh * self.pages_per_shard).to(tab.dtype)[:, None]

    def slot_pages(self, slot: torch.Tensor, phys: torch.Tensor
                   ) -> torch.Tensor:
        """One slot's shard-local pages ``phys`` -> the device's, on the
        slot's shard; a parked slot (``n_slots``) counts as the last
        shard's, so its writes land on that shard's trash page."""
        sh = torch.clamp(slot.long() // self.n_local, max=self.dp - 1)
        return phys.long() + sh * self.pages_per_shard


def shard_map_compat(fn: Callable, layout: ShardLayout,
                     in_specs: Sequence[Optional[str]]) -> Callable:
    """``fn`` (the single-device body) over ``layout``'s shards on one
    device.  ``in_specs`` names, per operand, what it holds: ``"lanes"``
    (shard-local lane indices, :meth:`ShardLayout.lanes`), ``"pages"`` (a
    shard-local page table, :meth:`ShardLayout.pages`) or ``None`` (passed
    as is: replicated operands, or per-lane values already laid out
    shard-major).  Data axes only: the bodies are lane-local, so there is
    no collective, nothing is split or gathered, and ``fn`` runs once
    over every shard's rows, launching each kernel once."""
    conv = [None if s is None else getattr(layout, s) for s in in_specs]

    def body(*args):
        return fn(*[a if c is None else c(a) for a, c in zip(args, conv)])
    return body
