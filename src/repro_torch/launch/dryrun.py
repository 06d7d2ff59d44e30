"""Multi-pod dry-run (port of ``repro.launch.dryrun``): trace one step of
every (architecture x input shape x mesh) cell per device and take its
roofline terms.

The reference compiles each cell for 512 placeholder host devices and
reads the compiled program.  PyTorch has no SPMD compiler; its
counterpart here is DTensor propagation over a ``DeviceMesh`` whose
process group is torch's ``fake`` backend (``launch.mesh.make_dryrun_mesh``:
``(16, 16)`` over ``('data', 'model')``, or ``(2, 16, 16)`` with
``'pod'``), on fake tensors.  The cell's parameters, optimiser state,
batch and serve state are fake tensors from the start (no memory, no
random draws), laid out by the port's ``params_pspecs``,
``batch_pspecs`` and ``serve_state_pspecs`` as DTensors; one step (the
train step, ``prefill`` or ``decode_step``) runs eagerly under the
activation rules and is counted per device by the cost analyzer
(``analysis.cost``: local shards, the collectives of every
redistribution, the peak of live bytes).  It runs on the CPU and on no
card by design, as the reference's placeholder devices do; the SWAN
reads go through their plain versions, as the reference's dry-run skips
its kernels under rules.

Where DTensor has no sharding strategy for an op of the step, or the op
writes in place into a sharded tensor whose placement DTensor cannot
keep, the op runs replicated (:class:`DryRunDispatch`): its other
DTensor operands are gathered (counted as collectives, an honest
per-device cost) and it runs on whole tensors.  An in-place target is
not gathered: each device writes its own shard.  The record lists those
ops under ``replicated_ops``; no cell is skipped for them.  Before that,
gathers, ``logsumexp`` and matmuls over strided shards run on the local
shards by rules of this module where DTensor would gather a split
operand whole (an embedding lookup from a vocabulary-split table, a
cache row from a sequence-split cache) or has no strategy, and a view
DTensor cannot lay out (8 KV heads over 16 devices) gathers the fewest
mesh axes it takes.

MUST run in a process of its own (``python -m repro_torch.launch.dryrun``,
or a test's subprocess): the fake default process group it starts would
leak into everything later in the process, the counterpart of the
reference's XLA flag.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k [--multi-pod] [--swan]
  python -m repro_torch.launch.dryrun --all --out experiments/dryrun_torch [--sample-depth] [--jobs 6]

Beside the reference's flags, ``--sample-depth`` traces each cell at 0
and 1 unit of depth and extends the counts (``build_cell``), and
``--jobs N`` traces N cells at once, each in a process of its own: a
full-depth trace costs milliseconds of host time per DTensor op, which
is minutes for a deep cell and, for jamba's Mamba scans, hours.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map as pytree_map

from repro_torch.analysis.cost import CostMode, count_collective
from repro_torch.analysis.roofline import roofline_report
from repro_torch.configs import SHAPES, SwanConfig, get_config, shape_applicable
from repro_torch.configs.base import OptimizerConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.io import decode_input_specs, train_input_specs
from repro_torch.models.registry import get_model, swan_applicable
from repro_torch.optim.adamw import init_opt_state
from repro_torch.runtime.train_loop import make_train_step
from repro_torch.sharding.api import (P, is_dtensor, local_shape,
                                      to_placements, use_rules)
from repro_torch.sharding.serve_specs import (batch_pspecs, sanitize_tree,
                                              serve_state_pspecs)
from repro_torch.sharding.specs import activation_rules, params_pspecs
from repro_torch.tree import tree_map

# messages of DTensor's refusals that the fallback answers
_REFUSALS = ("sharding strategy", "Sharding propagation failed",
             "require placement changes")


# a view DTensor cannot lay out: a split dim cut into dims that the mesh
# axis does not divide (8 KV heads over 16 devices), refused, or given
# local shapes that do not hold the local shard
_VIEWS = {torch.ops.aten.view, torch.ops.aten._unsafe_view,
          torch.ops.aten.reshape}
_BAD_VIEWS = ("is invalid for input of size",)


def _refused(e: Exception, operands) -> bool:
    """Whether ``e`` is DTensor refusing an op: one of its messages, or a
    strided shard's redistribution reading index values, which a fake
    tensor does not have."""
    return (any(r in str(e) for r in _REFUSALS)
            or (type(e).__name__ == "DataDependentOutputException"
                and any(_strided(x) for x in operands)))


def _local_rules():
    """Ops run on the local shards by a rule of this module, where
    DTensor's own strategy would gather a split operand whole or has
    none: {op: (when, rule)}."""
    aten = torch.ops.aten

    def first(a, k):
        return is_dtensor(a[0])

    def strided(a, k):
        return any(_strided(x) for x in a)
    return {
        aten.index.Tensor: (first, lambda a, k: _local_index(*a)),
        aten.gather.default: (
            lambda a, k: first(a, k) and len(a) == 3
            and not k.get("sparse_grad"), lambda a, k: _local_gather(*a)),
        aten.logsumexp.default: (first,
                                 lambda a, k: _local_logsumexp(*a, **k)),
        aten.mm.default: (strided, lambda a, k: _local_mm(*a)),
        aten.bmm.default: (strided, lambda a, k: _local_bmm(*a)),
    }


class DryRunDispatch(TorchDispatchMode):
    """The dry-run's dispatch over DTensor, in this order: the local rules
    (``_local_rules``: gathers, ``logsumexp`` and strided-batch matmuls
    on the local shards); DTensor's own strategy; for a strided shard of
    split factor 1, DTensor again on the plain shard it is; for a view
    DTensor cannot lay out, the fewest mesh axes of its input gathered
    (``view (an axis gathered)`` in ``ops``); else, for an op DTensor
    refuses (no sharding strategy, or an in-place write whose target's
    placement it cannot keep), the op on replicated operands, named in
    ``ops``: the counterpart of registering an all-replicate strategy,
    which DTensor does not accept for an in-place op on a sharded
    target.  ``REPRO_DRYRUN_DEBUG=1`` prints each replicated op with its
    operands' placements."""

    def __init__(self):
        super().__init__()
        self.ops = set()
        self.rules = _local_rules()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        when, rule = self.rules.get(func, (None, None))
        if rule is not None and when(args, kwargs):
            out = rule(args, kwargs)
            if out is not None:
                return out
        try:
            return func(*args, **kwargs)
        except (RuntimeError, NotImplementedError) as e:
            flat = tree_flatten((args, kwargs))[0]
            if not any(is_dtensor(x) for x in flat):
                raise
            refused = _refused(e, flat)
            view = (func._overloadpacket in _VIEWS and is_dtensor(args[0])
                    and (refused or any(r in str(e) for r in _BAD_VIEWS)))
            if not view and not refused:
                raise
        if any(_strided(x, plain_only=True) for x in flat):
            # a strided shard of split factor 1 is a plain shard, which
            # DTensor does not see: say so and try again
            try:
                return func(*pytree_map(_plain, args),
                            **pytree_map(_plain, kwargs))
            except (RuntimeError, NotImplementedError) as e:
                if not (_refused(e, flat)
                        or any(r in str(e) for r in _BAD_VIEWS)):
                    raise
        if view:
            out = _view_gathering(func, args, kwargs)
            if out is not None:
                self.ops.add(func._overloadpacket.__name__ + " (an axis "
                             "gathered)")
                return out
        self.ops.add(str(func._overloadpacket.__name__))
        if os.environ.get("REPRO_DRYRUN_DEBUG"):
            print("[replicated]", func, [
                (tuple(x.shape), tuple(x.placements)) if is_dtensor(x)
                else type(x).__name__ for x in tree_flatten(args)[0]],
                flush=True)
        return self._replicated(func, args, kwargs)

    @staticmethod
    def _replicated(func, args, kwargs):
        targets = set()
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                val = args[i] if i < len(args) else kwargs.get(a.name)
                targets |= {id(t) for t in tree_flatten(val)[0]}
        mesh = next(x.device_mesh for x in tree_flatten((args, kwargs))[0]
                    if is_dtensor(x))

        def whole(x):
            if not is_dtensor(x):
                return x
            if id(x) not in targets:
                # the gather this device would receive: an all-reduce of
                # its partial sums, then an all-gather of the whole tensor
                loc = x._local_tensor
                if any(p.is_partial() for p in x.placements):
                    count_collective("all_reduce",
                                     loc.numel() * loc.element_size())
                if any(not (p.is_partial() or p.is_replicate())
                       for p in x.placements):
                    count_collective("all_gather_into_tensor",
                                     x.numel() * x.element_size())
            # an in-place target is not gathered: each device writes its
            # own shard
            return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype)
        out = func(*pytree_map(whole, args), **pytree_map(whole, kwargs))
        if targets:
            ret = [x for x in tree_flatten((args, kwargs))[0]
                   if id(x) in targets]
            return ret[0] if len(ret) == 1 else tuple(ret)

        def wrap(x):
            if not isinstance(x, torch.Tensor):
                return x
            from torch.distributed.tensor import DTensor, Replicate
            return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                      run_check=False)
        return pytree_map(wrap, out)


def _strided_pl(p) -> bool:
    return type(p).__name__ == "_StridedShard"


def _shard_like(p) -> bool:
    return type(p).__name__ in ("Shard", "_StridedShard")


def _strided(x, plain_only: bool = False) -> bool:
    """Whether DTensor ``x`` has a strided shard (of split factor 1 only,
    with ``plain_only``)."""
    return is_dtensor(x) and any(
        _strided_pl(p) and (not plain_only or p.split_factor == 1)
        for p in x.placements)


def _plain(x):
    """``x`` with its strided shards of split factor 1 (the same rows as a
    plain shard) as plain ``Shard``s: the same local tensor."""
    if not _strided(x, plain_only=True):
        return x
    from torch.distributed.tensor import DTensor, Shard
    pls = [Shard(p.dim) if _strided_pl(p) and p.split_factor == 1 else p
           for p in x.placements]
    return DTensor.from_local(x._local_tensor, x.device_mesh, pls,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def _local_logsumexp(x, dim, keepdim: bool = False):
    """``torch.logsumexp`` over dims some of which are split: each device
    reduces its shard, then a max and a sum all-reduce of the local
    result merge the shards (the reference's pmax + psum); dims that are
    split and not reduced stay split.  DTensor's own strategy gathers
    ``x`` whole.  Returns None for a layout it does not cover."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dims = sorted(d % x.ndim for d in (dim if isinstance(dim, (list, tuple))
                                       else [dim]))
    if any(type(p) not in (Shard, Replicate) for p in x.placements):
        return None
    out_pl = []
    split_reduced = False
    for p in x.placements:
        if p.is_shard() and p.dim in dims:
            split_reduced = True
            out_pl.append(Replicate())
        elif p.is_shard():
            out_pl.append(Shard(p.dim if keepdim else
                                p.dim - sum(d < p.dim for d in dims)))
        else:
            out_pl.append(Replicate())
    with _fake_of(x):
        out = torch.logsumexp(x._local_tensor, dims, keepdim)
        whole = torch.logsumexp(torch.empty(x.shape, dtype=x.dtype), dims,
                                keepdim)
    if split_reduced:
        for _ in range(2):
            count_collective("all_reduce", out.numel() * out.element_size())
    return DTensor.from_local(out, x.device_mesh, out_pl, run_check=False,
                              shape=whole.shape, stride=whole.stride())


def _local_bmm(a, b):
    """``torch.bmm(a, b)`` on the local shards where an operand's batch dim
    is a strided shard (a split dim merged into the batch: heads folded
    into it), which DTensor has no strategy for: the batch stays split as
    it is (the result carries the operands' placement, so the view back
    unfolds it; the strided one where they differ), a split contraction
    dim gives a ``Partial`` result and a split row or column dim stays
    split.  A whole operand is cut to the other's local batch where it
    lies, for free; operands split in different row orders cost an
    all-to-all of the smaller one; a batch split of ``a`` against split
    columns of ``b`` (queries against a cache split along its sequence)
    gathers ``a``'s batch over that axis.  Returns None for a layout it
    does not cover."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = next(x.device_mesh for x in (a, b) if is_dtensor(x))
    rep = [Replicate()] * mesh.ndim
    pa = list(a.placements) if is_dtensor(a) else rep
    pb = list(b.placements) if is_dtensor(b) else rep
    out_pl = []
    sa, sb = list(a.shape), list(b.shape)
    for m in range(mesh.ndim):
        x, y = pa[m], pb[m]
        n = mesh.size(m)
        xb = not (x.is_replicate() or x.is_partial()) and x.dim == 0
        yb = not (y.is_replicate() or y.is_partial()) and y.dim == 0
        if xb and type(y) is Shard and y.dim == 2:
            # a split batch against split columns (q against a cache split
            # along its sequence): gather the batch axis of ``a``
            count_collective("all_gather_into_tensor",
                             int(np.prod(sa)) * a.element_size())
            out_pl.append(Shard(2))
            sb[2] //= n
            continue
        if xb or yb:
            if (xb and not (yb or y.is_replicate())) \
                    or (yb and not (xb or x.is_replicate())):
                return None
            if xb and yb and x != y:
                # the same split in another row order: the smaller operand
                # is reordered to the other's, an all-to-all of its shard
                small = min((a, b), key=lambda t: t.numel())
                count_collective("all_to_all_single",
                                 small._local_tensor.numel()
                                 * small._local_tensor.element_size())
            # the strided split where the two differ: its view back
            # unfolds the heads again
            out_pl.append(y if (not xb or (yb and _strided_pl(y)))
                          else x)
            sa[0] //= n
            sb[0] //= n
        elif x.is_replicate() and y.is_replicate():
            out_pl.append(Replicate())
        elif type(x) is Shard and x.dim == 2 and type(y) is Shard \
                and y.dim == 1:
            out_pl.append(Partial())
            sa[2] //= n
            sb[1] //= n
        elif _shard_like(x) and x.dim == 1 and y.is_replicate():
            out_pl.append(x)           # split rows stay split as they are
            sa[1] //= n
        elif _shard_like(y) and y.dim == 2 and x.is_replicate():
            out_pl.append(y)
            sb[2] //= n
        else:
            return None
    with _fake_of(a if is_dtensor(a) else b):
        la = (a._local_tensor if is_dtensor(a)
              and list(a._local_tensor.shape) == sa
              else torch.empty(sa, dtype=a.dtype))
        lb = (b._local_tensor if is_dtensor(b)
              and list(b._local_tensor.shape) == sb
              else torch.empty(sb, dtype=b.dtype))
        out = torch.bmm(la, lb)
    shape = (a.shape[0], a.shape[1], b.shape[2])
    return DTensor.from_local(out, mesh, out_pl, run_check=False,
                              shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _local_mm(a, b):
    """``torch.mm(a, b)`` on the local shards where ``a``'s rows are a
    strided shard (batch and sequence folded into tokens under sequence
    sharding), which DTensor has no strategy for.  Per mesh axis: rows
    split against a whole ``b`` stay split; against ``b`` split along
    the contraction (FSDP) ``b`` is gathered; against ``b`` split along
    its columns (tensor parallel) the rows are gathered and the columns
    stay split; a split contraction on both sides gives a ``Partial``
    result.  Each gather is counted.  Returns None for a layout it does
    not cover."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = next(x.device_mesh for x in (a, b) if is_dtensor(x))
    rep = [Replicate()] * mesh.ndim
    pa = list(a.placements) if is_dtensor(a) else rep
    pb = list(b.placements) if is_dtensor(b) else rep
    if any(p.is_partial() for p in pa + pb):
        return None
    sa, sb = list(a.shape), list(b.shape)
    out_pl, gather_a, gather_b = [], [], []
    for m in range(mesh.ndim):
        x, y = pa[m], pb[m]
        rows = _shard_like(x) and x.dim == 0
        if rows and (y.is_replicate() or (type(y) is Shard and y.dim == 0)):
            if not y.is_replicate():
                gather_b.append(m)
            out_pl.append(x)
        elif (rows or x.is_replicate()) and type(y) is Shard and y.dim == 1:
            if rows:
                gather_a.append(m)
            out_pl.append(Shard(1))
        elif type(x) is Shard and x.dim == 1 and type(y) is Shard \
                and y.dim == 0:
            out_pl.append(Partial())
        elif x.is_replicate() and y.is_replicate():
            out_pl.append(Replicate())
        elif x.is_replicate() and type(y) is Shard and y.dim == 0:
            gather_b.append(m)
            out_pl.append(Replicate())
        else:
            return None
    for m, p in enumerate(pa):
        if _shard_like(p) and m not in gather_a:
            sa[p.dim] //= mesh.size(m)
    for m, p in enumerate(pb):
        if _shard_like(p) and m not in gather_b:
            sb[p.dim] //= mesh.size(m)
    for t, gathered, shape in ((a, gather_a, sa), (b, gather_b, sb)):
        if gathered:
            count_collective("all_gather_into_tensor",
                             int(np.prod(shape)) * t.element_size())
    with _fake_of(a if is_dtensor(a) else b):
        out = torch.mm(torch.empty(sa, dtype=a.dtype),
                       torch.empty(sb, dtype=b.dtype))
    shape = (a.shape[0], b.shape[1])
    return DTensor.from_local(out, mesh, out_pl, run_check=False,
                              shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _fake_of(x):
    """The fake mode of a DTensor's local shard (a null context when its
    local tensor is real)."""
    import contextlib
    mode = getattr(x._local_tensor, "fake_mode", None)
    return mode if mode is not None else contextlib.nullcontext()


def _local_index(src, indices):
    """``src[indices]`` (``aten.index.Tensor``) on the local shards, as an
    SPMD partitioner runs a gather: a dim of ``src`` split over a mesh axis
    and indexed is read where it lives (out-of-shard rows read as zeros)
    and the result is ``Partial`` over that axis (an all-reduce when it is
    next read whole); a dim split and not indexed stays split in the
    result, and so does the broadcast index dim of an index split over an
    axis on which ``src`` is whole (every index tensor cut alike).  An
    index split over an axis on which ``src`` is split too is gathered
    first.  DTensor's own strategy for
    this op gathers ``src`` whole.  Returns None for a layout it does not
    cover (a strided shard), which DTensor then handles."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = src.device_mesh
    pls = list(src.placements)
    idx_pls = [list(ix.placements) for ix in indices if is_dtensor(ix)]
    if any(type(p) not in (Shard, Replicate, Partial)
           for p in pls + sum(idx_pls, [])):
        return None
    dims = [d for d, ix in enumerate(indices) if ix is not None]
    b_ndim = max(ix.ndim for ix in indices if ix is not None)
    adjacent = dims == list(range(dims[0], dims[-1] + 1))
    first = dims[0] if adjacent else 0
    rest = [d for d in range(src.ndim) if d not in dims]

    def out_dim(d):
        if adjacent:
            return d if d < first else d - len(dims) + b_ndim
        return b_ndim + rest.index(d)
    # one layout for every index tensor, in broadcast dims: whole over an
    # axis that splits ``src`` (gathered there), else split as the first
    # split index is (the others cut to it where they lie, for free)
    ixs = [ix for ix in indices if ix is not None]
    target = []
    for m, p in enumerate(pls):
        bdim = None
        if not (p.is_shard() or p.is_partial()):
            for ix in ixs:
                ip = ix.placements[m] if is_dtensor(ix) else Replicate()
                if ip.is_shard():
                    bdim = b_ndim - ix.ndim + ip.dim
                    break
        target.append(bdim)
    local_ix = []
    for ix in indices:
        if ix is None:
            local_ix.append(None)
            continue
        off = b_ndim - ix.ndim
        want = [Shard(b - off) if b is not None and b >= off
                and ix.shape[b - off] > 1 else Replicate() for b in target]
        have = (list(ix.placements) if is_dtensor(ix)
                else [Replicate()] * mesh.ndim)
        if have == want:
            local_ix.append(ix._local_tensor if is_dtensor(ix) else ix)
            continue
        shape = list(ix.shape)
        for m, p in enumerate(want):
            if p.is_shard():
                shape[p.dim] = -(-shape[p.dim] // mesh.size(m))
        if any(h.is_shard() and h != w for h, w in zip(have, want)):
            count_collective("all_gather_into_tensor",
                             int(np.prod(shape)) * ix.element_size())
        with _fake_of(src):
            local_ix.append(torch.empty(shape, dtype=ix.dtype))
    out_pl = []
    for m, p in enumerate(pls):
        if p.is_shard():
            out_pl.append(Partial() if p.dim in dims else
                          Shard(out_dim(p.dim)))
        elif p.is_partial():
            out_pl.append(Partial())
        else:
            out_pl.append(Replicate() if target[m] is None
                          else Shard(first + target[m]))
    whole = torch.ops.aten.index.Tensor(
        torch.empty(src.shape, dtype=src.dtype),
        [None if ix is None else torch.empty(ix.shape, dtype=ix.dtype)
         for ix in indices])
    out = torch.ops.aten.index.Tensor(src._local_tensor, local_ix)
    return DTensor.from_local(out, mesh, out_pl, run_check=False,
                              shape=whole.shape, stride=whole.stride())


def _local_gather(src, dim: int, index):
    """``torch.gather(src, dim, index)`` on the local shards, as
    :func:`_local_index` runs an index: ``src`` split along ``dim`` gives
    a ``Partial`` result (each device reads the entries it holds); split
    along another dim, the result is split there too and ``index`` is cut
    to match (a replicated index is cut where it lies, for free).  DTensor's
    own strategy (a masked partial) fails to reduce after a later select.
    Returns None for a layout it does not cover."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = src.device_mesh
    dim = dim % src.ndim
    ipl = (list(index.placements) if is_dtensor(index)
           else [Replicate()] * mesh.ndim)
    if any(type(p) not in (Shard, Replicate, Partial)
           for p in list(src.placements) + ipl):
        return None
    out_pl = []
    for m, ps in enumerate(src.placements):
        pi = ipl[m]
        if ps.is_partial() or (ps.is_shard() and ps.dim == dim):
            if pi.is_shard():
                count_collective("all_gather_into_tensor",
                                 index.numel() * index.element_size())
            out_pl.append(Partial())
        elif ps.is_shard():
            if pi.is_shard() and pi.dim != ps.dim:
                return None
            out_pl.append(Shard(ps.dim))
        else:
            out_pl.append(pi if pi.is_shard() else Replicate())
    shape = list(index.shape)
    for m, p in enumerate(out_pl):
        if p.is_shard():
            shape[p.dim] //= mesh.size(m)
    with _fake_of(src):
        loc_ix = torch.empty(shape, dtype=index.dtype)
        out = torch.gather(src._local_tensor, dim, loc_ix)
    return DTensor.from_local(out, mesh, out_pl, run_check=False,
                              shape=index.shape,
                              stride=torch.empty(index.shape,
                                                 device="meta").stride())


def _gather_axis(x, m: int):
    """``x`` with mesh axis ``m`` gathered (its placement there
    ``Replicate``), counted as the all-gather (an all-reduce for a
    partial sum) it takes; built from a fresh local shard of the new
    layout (rank 0's: split dims rounded up, as DTensor splits them)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    pls = list(x.placements)
    was = pls[m]
    pls[m] = Replicate()
    shape = list(x.shape)
    for i, p in enumerate(pls):
        if not (p.is_replicate() or p.is_partial()):
            shape[p.dim] = -(-shape[p.dim] // mesh.size(i))
    with _fake_of(x):
        loc = torch.empty(shape, dtype=x.dtype)
    count_collective("all_reduce" if was.is_partial()
                     else "all_gather_into_tensor",
                     loc.numel() * loc.element_size())
    return DTensor.from_local(loc, mesh, pls, run_check=False,
                              shape=x.shape, stride=x.stride())


def _view_gathering(func, args, kwargs):
    """A view DTensor cannot lay out, run after gathering as few mesh axes
    of its input as it takes (innermost first): an SPMD partitioner would
    split the dim over the new dims instead, which a DTensor placement
    cannot say.  None when even the whole input does not do."""
    x = args[0]
    for m in reversed(range(x.device_mesh.ndim)):
        if x.placements[m].is_replicate():
            continue
        x = _gather_axis(x, m)
        try:
            return func(x, *args[1:], **kwargs)
        except (RuntimeError, NotImplementedError) as e:
            if not (_refused(e, [x]) or any(r in str(e) for r in _BAD_VIEWS)):
                raise
    return None


def default_swan(cfg, mode: str = "topk", quantize: bool = False) -> SwanConfig:
    """Paper-faithful default: 50% retention, 128-token buffer (Fig. 2b)."""
    return SwanConfig(k_max=cfg.d_head // 2, buffer=128, mode=mode,
                      quantize=quantize)


def _distribute(tree, specs, mesh, fake_mode):
    """Each meta leaf of ``tree`` as a DTensor laid out by its spec: a
    fake local shard of the per-device shape, rank 0's."""
    from torch.distributed.tensor import DTensor

    def one(x, spec):
        with fake_mode:
            loc = torch.empty(local_shape(x.shape, spec, mesh),
                              dtype=x.dtype)
        return DTensor.from_local(
            loc, mesh.device_mesh, to_placements(spec, mesh),
            run_check=False, shape=x.shape,
            stride=torch.empty(x.shape, device="meta").stride())
    return tree_map(one, tree, specs)


def _local_bytes(tree) -> int:
    return sum(x._local_tensor.numel() * x._local_tensor.element_size()
               if is_dtensor(x) else x.numel() * x.element_size()
               for x in tree_flatten(tree)[0]
               if isinstance(x, torch.Tensor))


def _n_proj_layers(cfg) -> int:
    if cfg.mamba is not None:
        return cfg.n_layers // cfg.attn_period
    return cfg.n_layers


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               swan_on: bool, swan_mode: str = "topk",
               swan_quantize: bool = False,
               overrides: Optional[Dict[str, Any]] = None,
               sample_depth: bool = False) -> Dict[str, Any]:
    """Trace one cell's step per device; return its record (the
    reference's keys, ``step_cost`` for ``hlo_cost``, ``trace_s`` for
    ``lower_s``, plus ``replicated_ops``).

    ``sample_depth`` traces the step at 0 and 1 unit of the layer stack
    (a layer; a group of ``attn_period`` layers for the hybrid family)
    and extends every count linearly to the config's depth, as the
    reference's analyzer multiplies its layer scan's body by the trip
    count: the stacked layers are alike, so that holds for flops, bytes,
    collectives and a train step's ``temp_bytes`` (llama3-8b's and
    olmo-1b's within 1.2 % of their full-depth traces); a serve step's
    ``temp_bytes`` is the larger traced peak.  The record says so under
    ``depth_sampled``."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "swan": swan_on, "status": "skipped", "reason": reason}
    if swan_on and not swan_applicable(cfg):
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "swan": swan_on, "status": "skipped",
                "reason": "SWAN inapplicable (no KV cache)"}
    swan = default_swan(cfg, swan_mode, swan_quantize) if swan_on else None
    head = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
            "swan": swan_on, "status": "ok"}
    unit = cfg.attn_period if cfg.mamba is not None else 1
    if not sample_depth or cfg.n_layers <= unit:
        rec = {**head, **_trace_cell(cfg, shape, multi_pod, swan)}
    else:
        r0 = _trace_cell(cfg.replace(n_layers=0), shape, multi_pod, swan)
        r1 = _trace_cell(cfg.replace(n_layers=unit), shape, multi_pod, swan)
        rec = {**head, **_extend(r0, r1, cfg.n_layers // unit,
                                 shape.kind == "train")}
        rec["depth_sampled"] = {"traced_layers": [0, unit],
                                "layers": cfg.n_layers}
    rec["roofline"] = roofline_report(rec, cfg, shape, swan)
    return rec


def _extend(r0, r1, units: int, train: bool) -> Dict[str, Any]:
    """A record at ``units`` units of depth from the traces at 0 and 1:
    every count c0 + units * (c1 - c0); a serve step's ``temp_bytes`` is
    the larger traced peak (its temporaries live a layer at a time),
    a train step's grows with the activations saved per unit."""
    def lin(a, b):
        return a + units * (b - a)
    c0, c1 = r0["step_cost"], r1["step_cost"]
    cost = {k: lin(c0[k], c1[k]) for k in ("flops", "hbm_bytes",
                                          "collective_bytes",
                                          "matmul_flops")}
    cost.update({k: int(lin(c0[k], c1[k])) for k in (
        "collective_count", "host_transfers", "n_ops")})
    kinds = set(c0["per_collective"]) | set(c1["per_collective"])
    cost["per_collective"] = {k: lin(c0["per_collective"].get(k, 0.0),
                                     c1["per_collective"].get(k, 0.0))
                              for k in sorted(kinds)}
    cost["kernel_launches"] = {}
    return {"n_devices": r1["n_devices"],
            "trace_s": round(r0["trace_s"] + r1["trace_s"], 1),
            "memory": {k: int(lin(r0["memory"][k], r1["memory"][k])
                              if train or k != "temp_bytes"
                              else max(r0["memory"][k], r1["memory"][k]))
                       for k in r1["memory"]},
            "step_cost": cost,
            "replicated_ops": sorted(set(r0["replicated_ops"])
                                     | set(r1["replicated_ops"]))}


def _trace_cell(cfg, shape, multi_pod: bool, swan) -> Dict[str, Any]:
    """One traced step of ``cfg`` at ``shape`` per device: the record's
    counted fields."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    swan_on = swan is not None
    mesh = mesh_mod.make_dryrun_mesh(multi_pod=multi_pod)
    api = get_model(cfg)
    rules = activation_rules(cfg, mesh)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    t0 = time.monotonic()

    params_abs = api.init_params(cfg, 0, "meta")
    p_specs = sanitize_tree(params_pspecs(params_abs, cfg, mesh), params_abs,
                            mesh)
    params = _distribute(params_abs, p_specs, mesh, fake)
    fallback = DryRunDispatch()

    def run(fn):
        with fake, implicit_replication(), use_rules(rules), fallback, \
                CostMode(track_memory=True) as cm:
            out = fn()
        return out, cm.costs

    if shape.kind == "train":
        opt_cfg = OptimizerConfig()
        opt_abs = init_opt_state(params_abs, opt_cfg)
        o_specs = {"m": p_specs, "v": p_specs, "step": P()}
        opt = _distribute(opt_abs, o_specs, mesh, fake)
        batch_abs = train_input_specs(cfg, shape.global_batch, shape.seq_len)
        batch = _distribute(batch_abs, batch_pspecs(batch_abs, mesh), mesh,
                            fake)
        args = (params, opt, batch)
        donated = (params, opt)
        # a grad_accum loop traced once and counted cfg.grad_accum times
        step = make_train_step(cfg, opt_cfg, cfg.grad_accum, count_only=True)
        out, costs = run(lambda: step(params, opt, batch))
    else:
        cache_len = shape.seq_len + cfg.n_prefix_tokens   # vlm prefix rows
        state_abs = api.init_serve_state(cfg, swan, shape.global_batch,
                                         cache_len, "meta")
        state = _distribute(state_abs, serve_state_pspecs(state_abs, mesh),
                            mesh, fake)
        proj = None
        if swan_on:
            n_proj = _n_proj_layers(cfg)
            proj_abs = {"p_qk": torch.empty(
                (n_proj, cfg.n_kv_heads, cfg.d_head, cfg.d_head),
                dtype=torch.float32, device="meta")}
            proj = _distribute(proj_abs, {"p_qk": P()}, mesh, fake)
        if shape.kind == "prefill":
            batch_abs = train_input_specs(cfg, shape.global_batch,
                                          shape.seq_len)
            batch = _distribute(batch_abs, batch_pspecs(batch_abs, mesh),
                                mesh, fake)
            args = (params, batch, state, proj)
            out, costs = run(lambda: api.prefill(params, cfg, batch, state,
                                                 swan, proj))
        else:   # decode
            tok_abs = decode_input_specs(cfg, shape.global_batch)
            tok = _distribute(tok_abs, batch_pspecs(tok_abs, mesh), mesh,
                              fake)["token"]
            pos = _distribute({"pos": torch.empty((), dtype=torch.int32,
                                                  device="meta")},
                              {"pos": P()}, mesh, fake)["pos"]
            args = (params, tok, pos, state, proj)
            out, costs = run(lambda: api.decode_step(params, cfg, tok, pos,
                                                     state, swan, proj))
        donated = (state,)
    t_trace = time.monotonic() - t0

    return {
        "n_devices": mesh.size,
        "trace_s": round(t_trace, 1),
        "memory": {
            "argument_bytes": _local_bytes(args),
            "output_bytes": _local_bytes(out),
            "temp_bytes": costs.peak_live_bytes,
            "alias_bytes": _local_bytes(donated),
        },
        "step_cost": costs.to_json(),
        "replicated_ops": sorted(fallback.ops),
    }


def iter_cells(multi_pod: bool, swan_variants: bool = True):
    from repro_torch.configs import ARCH_IDS
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape_name, shape in SHAPES.items():
            yield arch, shape_name, multi_pod, False
            if (swan_variants and shape.kind != "train"
                    and swan_applicable(cfg)
                    and shape_applicable(cfg, shape)[0]):
                yield arch, shape_name, multi_pod, True


def _cell_tag(arch, shape_name, mp, swan_on, suffix=""):
    tag = (f"{arch}__{shape_name}__{'mp' if mp else 'sp'}"
           f"{'__swan' if swan_on else ''}")
    return tag + (f"__{suffix}" if suffix else "")


def _done_line(tag: str, rec: Dict[str, Any]) -> str:
    status = rec["status"]
    extra = ""
    if status == "ok":
        r = rec["roofline"]
        extra = (f" compute={r['compute_s']:.2e}s memory={r['memory_s']:.2e}s"
                 f" coll={r['collective_s']:.2e}s dom={r['bottleneck']}"
                 f" (trace {rec['trace_s']}s)")
    return f"[done] {tag}: {status}{extra}"


def _run_jobs(cells, args, argv, jobs: int) -> int:
    """Each cell in a process of its own (this module's CLI on one cell),
    ``jobs`` at a time; returns the failures, read from their records."""
    import subprocess
    import sys
    passed = []
    skip = {"--all", "--jobs", "--skip-existing", "--arch", "--shape",
            "--multi-pod", "--swan"}
    it = iter(argv)
    for a in it:
        if a.split("=", 1)[0] in skip:
            if "=" not in a and a in ("--jobs", "--arch", "--shape"):
                next(it, None)
            continue
        passed.append(a)
    pending = list(cells)
    running = []
    n_fail = 0
    while pending or running:
        while pending and len(running) < jobs:
            arch, shape_name, mp, swan_on = pending.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape_name] + passed
            cmd += ["--multi-pod"] * mp + ["--swan"] * swan_on
            tag = _cell_tag(arch, shape_name, mp, swan_on, args.tag)
            print(f"[cell] {tag} ...", flush=True)
            running.append((tag, subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)))
        time.sleep(0.5)
        for item in [r for r in running if r[1].poll() is not None]:
            running.remove(item)
            tag = item[0]
            path = os.path.join(args.out, tag + ".json")
            try:
                with open(path, encoding="utf-8") as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                rec = {"status": "error"}
            n_fail += rec["status"] == "error"
            print(_done_line(tag, rec), flush=True)
    return n_fail


def main(argv=None) -> int:
    import sys
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--swan", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--swan-mode", default="topk", choices=["topk", "truncate"])
    ap.add_argument("--swan-quantize", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=val (int), e.g. grad_accum=4")
    ap.add_argument("--tag", default="", help="suffix for the output file")
    ap.add_argument("--sample-depth", action="store_true",
                    help="trace 0 and 1 unit of the layer stack and extend "
                         "the counts to the config's depth")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in its own process")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = int(v) if v.lstrip("-").isdigit() else v

    os.makedirs(args.out, exist_ok=True)
    cells = (list(iter_cells(args.multi_pod)) if args.all
             else [(args.arch, args.shape, args.multi_pod, args.swan)])
    todo = []
    for cell in cells:
        tag = _cell_tag(*cell, args.tag)
        if args.skip_existing and os.path.exists(
                os.path.join(args.out, tag + ".json")):
            print(f"[skip existing] {tag}", flush=True)
            continue
        todo.append(cell)
    if args.jobs > 1 and len(todo) > 1:
        n_fail = _run_jobs(todo, args, argv, args.jobs)
        print(f"dry-run finished, failures: {n_fail}", flush=True)
        return 1 if n_fail else 0
    n_fail = 0
    for arch, shape_name, mp, swan_on in todo:
        tag = _cell_tag(arch, shape_name, mp, swan_on, args.tag)
        path = os.path.join(args.out, tag + ".json")
        print(f"[cell] {tag} ...", flush=True)
        try:
            rec = build_cell(arch, shape_name, mp, swan_on,
                             swan_mode=args.swan_mode,
                             swan_quantize=args.swan_quantize,
                             overrides=overrides or None,
                             sample_depth=args.sample_depth)
        except Exception as e:   # a failing cell is a bug — record & continue
            rec = {"arch": arch, "shape": shape_name, "multi_pod": mp,
                   "swan": swan_on, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
            n_fail += 1
        with open(path, "w", encoding="utf-8") as f:
            json.dump(rec, f, indent=1)
        print(_done_line(tag, rec), flush=True)
    print(f"dry-run finished, failures: {n_fail}", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
