"""Per-step cost analyzer: the port's counterpart of the reference's HLO
cost analyzer (``repro/analysis/hlo.py``).

The reference parses the post-optimisation HLO of a jitted step.  The port
has no HLO, so :func:`analyze_step` runs one eager step under a
``TorchDispatchMode`` and counts every aten op it dispatches, with the
reference's rules:

  * ``flops`` — matmuls at 2·M·N·K (``torch.utils.flop_counter``'s
    formulas: mm, bmm, addmm, baddbmm, convolution, attention; ``linear``,
    ``matmul`` and ``einsum`` reach the dispatcher as these), one flop per
    result element for the arithmetic elementwise ops of the reference's
    ``_EWISE_1FLOP`` (``hlo.py:54``, here under their aten names), and
    max(input, result) elements for a reduction (the reference's
    ``reduce``);
  * ``hbm_bytes`` — operand bytes plus result bytes per op (the reference's
    top-level-op approximation), with its two special cases: a gather
    reads only what it gathers (2 x result bytes) and a scatter reads its
    indices and updates and rewrites the region (3 x update bytes), never
    the whole target.  Views and allocations count zero; an in-place op
    reads and writes its target once (a copy or fill only writes it).
    Eager PyTorch runs without fusion: every intermediate goes through
    device memory, where XLA keeps a fusion's internals on-chip, so over
    a chain of ops this count bounds the fused HLO's from above.  Over a
    whole serve step the reference's count is the larger one all the
    same: it charges each cache array whole to the fusion that updates it
    in place, where the port's in-place writes count the rows they write
    (llama3-8b smoke: 0.72x of the reference's bytes on the prefill step,
    0.38x on the decode step; ``tests/test_torch_cost.py``);
  * ``collective_bytes`` / ``per_collective`` / ``collective_count`` — the
    result bytes of each c10d collective, by the reference's kind names
    (all zero on one card);
  * ``host_transfers`` — ``aten._local_scalar_dense`` (``.item()``,
    ``int()`` of a tensor) and every copy from a device tensor to the CPU.

A step over DTensors (the dry-run, ``launch.dryrun``) is counted per
device: the mode sees each op once, at the DTensor level and at global
shapes, and counts it over the local shards of its operands and results
(rank 0's): bytes and element counts from each DTensor's
``_local_tensor``, and a matmul's flops as its global flops times the
result's local share, divided by the size of every mesh axis over which
the result is ``Partial`` (a contraction split over that axis).  The
collectives that DTensor issues to redistribute an operand run inside
that op's dispatch, out of the mode's sight, so while a mode is active
every ``redistribute_local_tensor`` call of DTensor is observed and the
c10d collectives it dispatches are counted, each with its result bytes,
as above (an all-gather's gathered tensor, an all-reduce's tensor).
Explicit ``redistribute`` calls (the activation hooks) go the same way.
A fresh result is one whose storage no written operand shares, compared
by storage identity, which holds for real, fake and meta tensors alike.

``CostMode(track_memory=True)`` also keeps the peak of the live bytes the
step allocated (``StepCosts.peak_live_bytes``, the dry-run record's
``temp_bytes``): every fresh result's storage counts from the op that
made it until the last tensor object the mode saw on that storage (the
result itself or a view of it) is garbage-collected, each tracked with a
``weakref.finalize``.  Operands passed in are not counted, nor are the
tensors DTensor makes inside one op's dispatch.  A tensor that autograd
saves for the backward stays alive through the subclass's Python object
(a DTensor or fake tensor), so saved activations count until the
backward frees them.

Two things the dispatcher never sees:

  * the hand-written kernels launch through ``ctypes``: while a
    :class:`CostMode` is active it observes every launch the wrappers count
    (``kernels.build.CudaKernel.observer``) and records it with the ideal
    flops and bytes of ``analysis.roofline`` over the rows that launch
    reads (each kernel's ``cost``; B1-B4 stop at each sequence's
    ``sp_len``, which the analyzer reads with its counting and CUDA's sync
    debug mode paused), so a step on the card counts B1-B6 (on the CPU
    the wrappers run their plain twins, which dispatch aten ops as
    usual);
  * a CUDA-graph replay runs no aten op: analyse an eager step of the same
    shapes instead (graphed == eager bit for bit).
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.build import CudaKernel
from repro_torch.sharding.api import is_dtensor

# the reference's elementwise ops of one flop per result element
# (``hlo.py:54``), by their aten names
EWISE_1FLOP = {
    "add", "sub", "mul", "div", "maximum", "minimum", "abs", "neg", "exp",
    "log", "rsqrt", "sqrt", "tanh", "sigmoid", "pow", "floor", "ceil",
    "round", "cos", "sin", "expm1", "log1p", "atan2", "remainder",
}
# reductions: max(input, result) elements, as the reference's ``reduce``
REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod",
    "logsumexp", "all", "any", "cumsum",
}
# ops that move no bytes: allocations without a fill and aliasing reshapes
# that the schema does not mark as views
ZERO_BYTES = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_unsafe_view", "lift_fresh", "lift_fresh_copy", "detach", "alias",
    "resize_", "set_", "record_stream", "sym_size", "sym_stride",
    "sym_numel", "is_same_size",
}
# in-place ops whose target is written without being read
WRITE_ONLY = {"copy_", "fill_", "zero_", "normal_", "uniform_", "random_",
              "exponential_", "bernoulli_"}
# c10d ops (in-place ``c10d`` and functional ``_c10d_functional`` names,
# trailing underscore dropped) -> the reference's collective kind names
COLLECTIVES = {
    "allreduce": "all-reduce", "all_reduce": "all-reduce",
    "allgather": "all-gather", "_allgather_base": "all-gather",
    "all_gather_into_tensor": "all-gather", "allgather_into_tensor_coalesced":
    "all-gather", "reduce_scatter": "reduce-scatter",
    "_reduce_scatter_base": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter", "alltoall": "all-to-all",
    "alltoall_base": "all-to-all", "all_to_all_single": "all-to-all",
    "broadcast": "all-gather", "send": "collective-permute",
    "recv": "collective-permute", "recv_any_source": "collective-permute",
}
# ops that gather rows: they read only the gathered region, 2 x result
# bytes (the reference's gather rule); the logical-view detector reads
# their results
GATHERS = {"index", "index_select", "gather", "take", "embedding"}
# scatters, by the position of their updates argument: they read the
# indices and updates and read-modify-write the region, 3 x update bytes
# (the reference's scatter rule), never the whole target
SCATTERS = {"index_put": 2, "scatter": 3, "scatter_add": 3,
            "scatter_reduce": 3, "index_copy": 3, "index_add": 3,
            "masked_scatter": 2}


@dataclass
class OpCost:
    """One dispatched op (or reported kernel launch): its aten packet name
    (or the kernel's name), kind ("matmul", "ewise", "reduce", "kernel",
    "transfer", "collective" or "other"), flops, device bytes and the
    element count of its largest result."""
    name: str
    kind: str
    flops: float = 0.0
    hbm_bytes: float = 0.0
    out_elems: int = 0


@dataclass
class StepCosts:
    """The reference's ``HloCosts`` fields (``hlo.py:237``), plus ``ops``:
    every dispatched op and kernel launch of the step, in order."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    per_collective: Dict[str, float] = field(default_factory=dict)
    collective_count: int = 0
    host_transfers: int = 0
    peak_live_bytes: int = 0
    ops: List[OpCost] = field(default_factory=list)

    def add(self, op: OpCost) -> None:
        self.ops.append(op)
        self.flops += op.flops
        self.hbm_bytes += op.hbm_bytes
        if op.kind == "transfer":
            self.host_transfers += 1
        elif op.kind == "collective":
            kind = COLLECTIVES[op.name.rstrip("_")]
            self.collective_bytes += op.hbm_bytes
            self.collective_count += 1
            self.per_collective[kind] = (self.per_collective.get(kind, 0.0)
                                         + op.hbm_bytes)

    def flops_of(self, kind: str) -> float:
        """Flops of the ops of one kind (``"matmul"``, ``"kernel"``...)."""
        return sum(o.flops for o in self.ops if o.kind == kind)

    @property
    def kernel_launches(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for o in self.ops:
            if o.kind == "kernel":
                out[o.name] = out.get(o.name, 0) + 1
        return out

    def by_name(self) -> Dict[str, Dict[str, float]]:
        """{op name: {"count", "flops", "hbm_bytes"}}."""
        out: Dict[str, Dict[str, float]] = {}
        for o in self.ops:
            row = out.setdefault(o.name, {"count": 0, "flops": 0.0,
                                          "hbm_bytes": 0.0})
            row["count"] += 1
            row["flops"] += o.flops
            row["hbm_bytes"] += o.hbm_bytes
        return out

    def to_json(self) -> Dict[str, Any]:
        """The reference's record fields (``hlo_cost`` there, ``step_cost``
        here), with the op count and the kernels' launches."""
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": self.collective_bytes,
                "per_collective": dict(self.per_collective),
                "collective_count": self.collective_count,
                "host_transfers": self.host_transfers,
                "matmul_flops": self.flops_of("matmul"),
                "n_ops": len(self.ops),
                "kernel_launches": self.kernel_launches}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t):
    """A DTensor's local shard (rank 0's); anything else as it is."""
    return t._local_tensor if is_dtensor(t) else t


def _tensors(tree) -> List[torch.Tensor]:
    return [_local(x) for x in tree_flatten(tree)[0]
            if isinstance(x, torch.Tensor)]


def _storage_key(t: torch.Tensor):
    """The identity of ``t``'s storage (``id(t)`` for a tensor without
    one)."""
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError, AttributeError):
        return ("id", id(t))


def _local_share(out) -> float:
    """The share of a DTensor result's global work that one device does:
    its local elements over the global ones, over the size of every mesh
    axis on which it is ``Partial``; 1 for a plain result."""
    outs = [x for x in tree_flatten(out)[0] if isinstance(x, torch.Tensor)]
    if not outs or not is_dtensor(outs[0]):
        return 1.0
    t = outs[0]
    share = t._local_tensor.numel() / max(t.numel(), 1)
    for i, pl in enumerate(t.placements):
        if pl.is_partial():
            share /= t.device_mesh.size(i)
    return share


def is_host_copy(name: str, args: Tuple, kwargs: Dict,
                 out: Any) -> bool:
    """A copy from a device tensor to the CPU: ``copy_`` into a CPU tensor
    from a non-CPU one, or ``_to_copy``/``to`` of a non-CPU tensor whose
    result lies on the CPU."""
    if name == "copy_" and len(args) >= 2:
        dst, src = args[0], args[1]
        return (isinstance(src, torch.Tensor) and src.device.type != "cpu"
                and dst.device.type == "cpu")
    if name in ("_to_copy", "to", "_copy_from"):
        src = args[0] if args else None
        outs = _tensors(out)
        return (isinstance(src, torch.Tensor) and src.device.type != "cpu"
                and bool(outs) and outs[0].device.type == "cpu")
    return False


def _matmul_flops(func, args, kwargs, out) -> Optional[float]:
    formula = flop_registry.get(func._overloadpacket)
    if formula is None:
        return None
    return float(formula(*args, **kwargs, out_val=out)) * _local_share(out)


def op_cost(func, args: Tuple, kwargs: Dict, out: Any) -> OpCost:
    """The cost of one dispatched op under the rules of the module
    docstring."""
    name = func._overloadpacket.__name__
    flops = _matmul_flops(func, args, kwargs, out)
    if any(is_dtensor(x) for x in tree_flatten((args, kwargs, out))[0]):
        args, kwargs, out = (tree_map(_local, t) for t in (args, kwargs,
                                                             out))
    outs = _tensors(out)
    out_elems = max((t.numel() for t in outs), default=0)
    if name == "_local_scalar_dense" or is_host_copy(name, args, kwargs,
                                                     out):
        nbytes = sum(_nbytes(t) for t in _tensors(args[:1]))
        return OpCost(name, "transfer", 0.0, float(nbytes), out_elems)
    if name.rstrip("_") in COLLECTIVES:
        # received bytes per device: the result tensors, each once
        seen = {id(t): t for t in outs} or {id(t): t
                                            for t in _tensors(args[:1])}
        nbytes = sum(_nbytes(t) for t in seen.values())
        return OpCost(name, "collective", 0.0, float(nbytes), out_elems)
    if func.is_view or name in ZERO_BYTES:
        return OpCost(name, "other", 0.0, 0.0, out_elems)
    base = name[:-1] if name.endswith("_") else name
    if base in GATHERS:
        return OpCost(name, "other", 0.0,
                      float(2 * sum(_nbytes(t) for t in outs)), out_elems)
    if base in SCATTERS:
        pos = SCATTERS[base]
        upd = args[pos] if len(args) > pos else None
        nbytes = (_nbytes(upd) if isinstance(upd, torch.Tensor)
                  else _nbytes(args[pos - 1]))     # a scalar: the index's
        return OpCost(name, "other", 0.0, float(3 * nbytes), out_elems)
    schema = func._schema
    written: List[torch.Tensor] = []
    read: List[torch.Tensor] = []
    for i, a in enumerate(schema.arguments):
        val = args[i] if i < len(args) else kwargs.get(a.name)
        ts = _tensors(val)
        if a.alias_info is not None and a.alias_info.is_write:
            written += ts
            if name not in WRITE_ONLY and not a.kwarg_only:
                read += ts
        else:
            read += ts
    w_ids = {id(t) for t in written}
    w_views = {(_storage_key(t), t.storage_offset(), t.numel())
               for t in written if t.numel()}
    fresh = [t for t in outs if id(t) not in w_ids
             and (_storage_key(t), t.storage_offset(), t.numel())
             not in w_views]
    nbytes = (sum(_nbytes(t) for t in read) + sum(_nbytes(t) for t in written)
              + sum(_nbytes(t) for t in fresh))
    if flops is not None:
        return OpCost(name, "matmul", flops, float(nbytes), out_elems)
    if base in EWISE_1FLOP:
        return OpCost(name, "ewise", float(out_elems), float(nbytes),
                      out_elems)
    if base in REDUCTIONS:
        in_elems = max((t.numel() for t in _tensors(args[:1])), default=0)
        return OpCost(name, "reduce", float(max(in_elems, out_elems)),
                      float(nbytes), out_elems)
    return OpCost(name, "other", 0.0, float(nbytes), out_elems)


_ACTIVE: List["CostMode"] = []


class _RedistributeCollectives(TorchDispatchMode):
    """Active inside one DTensor ``redistribute_local_tensor`` call: hands
    each c10d collective it dispatches to ``sink`` and lets every op
    through."""

    def __init__(self, sink: Callable):
        super().__init__()
        self.sink = sink

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func._overloadpacket.__name__.rstrip("_") in COLLECTIVES:
            self.sink(op_cost(func, args, kwargs, out))
        return out


_REDISTRIBUTE: Dict[str, Any] = {}


def _observe_redistributions() -> None:
    """Wrap DTensor's ``redistribute_local_tensor`` (once, in every module
    of ``torch.distributed.tensor`` that holds it) so that, while a mode
    counts, the collectives it issues are counted into the innermost
    active mode (:class:`_RedistributeCollectives`).  A no-op until
    DTensor has been imported."""
    import sys
    red = sys.modules.get("torch.distributed.tensor._redistribute")
    if red is None or _REDISTRIBUTE:
        return
    orig = red.redistribute_local_tensor

    def wrapped(*args, **kwargs):
        if not analyzing():
            return orig(*args, **kwargs)
        mode = _ACTIVE[-1]
        mode._redistributing += 1
        try:
            with _RedistributeCollectives(mode.costs.add):
                return orig(*args, **kwargs)
        finally:
            mode._redistributing -= 1
    _REDISTRIBUTE["orig"] = orig
    for name, mod in list(sys.modules.items()):
        if (name.startswith("torch.distributed.tensor") and mod is not None
                and getattr(mod, "redistribute_local_tensor", None) is orig):
            mod.redistribute_local_tensor = wrapped


class CostMode(TorchDispatchMode):
    """Counts every op dispatched while it is active into ``costs``; the
    kernels' launches go to the innermost active mode (:func:`_observe`).
    ``paused()`` lets ops and launches through uncounted (an auditor's
    designed fetch points).  ``track_memory`` keeps the peak of the live
    bytes the step allocates (module docstring)."""

    def __init__(self, track_memory: bool = False):
        super().__init__()
        self.costs = StepCosts()
        self._paused = 0
        self._redistributing = 0
        self._track = track_memory
        self._live: Dict[Any, List[int]] = {}     # storage -> [bytes, refs]
        self._live_bytes = 0

    def __enter__(self):
        _ACTIVE.append(self)
        CudaKernel.observer = _observe
        _observe_redistributions()
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        if not _ACTIVE:
            CudaKernel.observer = None
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def paused(self) -> Iterator[None]:
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused and not self._redistributing:
            self.costs.add(op_cost(func, args, kwargs, out))
            if self._track:
                self._track_live(args, kwargs, out)
        return out

    def _track_live(self, args, kwargs, out) -> None:
        ins = {_storage_key(t) for t in _tensors((args, kwargs))}
        for t in _tensors(out):
            key = _storage_key(t)
            entry = self._live.get(key)
            if entry is None:
                if key in ins:          # an operand's storage: not ours
                    continue
                try:
                    nbytes = t.untyped_storage().nbytes()
                except (RuntimeError, NotImplementedError):
                    nbytes = _nbytes(t)
                entry = self._live[key] = [nbytes, 0]
                self._live_bytes += nbytes
                self.costs.peak_live_bytes = max(self.costs.peak_live_bytes,
                                                 self._live_bytes)
            entry[1] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] <= 0:
            self._live_bytes -= entry[0]
            del self._live[key]


def count_collective(name: str, nbytes: float) -> None:
    """Count a collective that the caller accounts for without dispatching
    it (``name`` a c10d op name of ``COLLECTIVES``, ``nbytes`` its result
    bytes per device) into the innermost counting mode, if any."""
    if analyzing():
        _ACTIVE[-1].costs.add(OpCost(name, "collective", 0.0, float(nbytes)))


@contextlib.contextmanager
def trip_count(n: int) -> Iterator[None]:
    """Count what runs inside ``n`` times: one trip of a loop body is
    traced and its ops are added ``n - 1`` more times on exit, the
    counterpart of the reference analyzer's ``known_trip_count``
    multiplier on a while loop's body.  The live-bytes peak stays the one
    trip's."""
    if not analyzing():
        yield
        return
    costs = _ACTIVE[-1].costs
    start = len(costs.ops)
    yield
    body = costs.ops[start:]
    for _ in range(n - 1):
        for op in body:
            costs.add(op)


def analyzing() -> bool:
    """Whether a :class:`CostMode` is counting: a kernel launch's cost is
    computed only then."""
    return bool(_ACTIVE) and not _ACTIVE[-1]._paused


@contextlib.contextmanager
def _sync_debug_off() -> Iterator[None]:
    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _observe(kernel: CudaKernel, args: tuple) -> None:
    """``CudaKernel.observer`` while a mode is active: the launch's cost
    from ``kernel.cost(*args)``, which may read a small device tensor
    (``sp_len``) to the host; that read is the analyzer's, not the step's,
    so it runs with the mode paused and CUDA's sync debug mode off."""
    if not analyzing():
        return
    mode = _ACTIVE[-1]
    with mode.paused(), _sync_debug_off():
        flops, nbytes = kernel.cost(*args)
    mode.costs.add(OpCost(kernel.name, "kernel", float(flops), float(nbytes)))


def analyze_step(fn: Callable, *args, track_memory: bool = False,
                 **kw) -> StepCosts:
    """The costs of one eager call ``fn(*args, **kw)`` (see the module
    docstring)."""
    with CostMode(track_memory) as mode:
        fn(*args, **kw)
    return mode.costs
