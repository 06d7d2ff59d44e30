"""Device meshes of the port (port of ``repro.launch.mesh``).

A :class:`Mesh` names its axes (``axis_names``), their sizes (``shape``,
axis -> size, as ``jax.sharding.Mesh.shape`` gives it) and holds its
devices as an object array of ``torch.device`` in the mesh's shape.
Building one touches no device state beyond counting the visible cards.

``devices=None`` takes the first N visible CUDA devices and raises when
fewer are visible, as ``jax.make_mesh`` does.  An explicit list may repeat
one device (``["cpu"] * 8``, ``["cuda:0"] * 2``): the port's counterpart
of the reference's ``--xla_force_host_platform_device_count``, named by
the caller and never a fallback.  ``make_production_mesh`` keeps the
reference's production shapes over ``meta`` placeholders (for shape
arithmetic; the serve engine refuses a ``meta`` mesh).
``make_dryrun_mesh`` lays the same shapes over a ``torch.distributed``
``DeviceMesh`` whose process group is torch's ``fake`` backend, one rank
per device: DTensor propagates placements over it and every collective
is a no-op, the counterpart of the reference dry-run's 512 placeholder
host devices (``repro_torch.launch.dryrun``).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """Named axes over an object array of ``torch.device``."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 device_mesh=None):
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis names {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.shape = OrderedDict(zip(axis_names, devices.shape))
        # a torch.distributed DeviceMesh of the same shape and names, for
        # DTensor placements (make_dryrun_mesh); None otherwise
        self.device_mesh = device_mesh

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _devices(n: int, devices: Optional[Sequence]) -> list:
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise ValueError(f"a mesh of {n} devices needs {n} visible CUDA "
                             f"devices, {have} visible; pass devices= to "
                             "lay the mesh over one device")
        return [torch.device("cuda", i) for i in range(n)]
    devs = [torch.device(d) for d in devices]
    if len(devs) != n:
        raise ValueError(f"a mesh of {n} devices got {len(devs)}")
    return devs


def make_mesh(shape, axes, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` (tests use small ones, e.g.
    ``(2, 4)``)."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape)) if shape else 1
    arr = np.empty((n,), dtype=object)
    for i, d in enumerate(_devices(n, devices)):
        arr[i] = d
    return Mesh(arr.reshape(shape), axes)


def make_serve_mesh(data_parallel: int,
                    devices: Optional[Sequence] = None) -> Mesh:
    """One-axis ``('data',)`` mesh for the sharded serve engine
    (``ServeEngine(mesh=...)``): the engine's batched state, and the paged
    pool's page axis, shard over ``data``; the weights are shared."""
    return make_mesh((int(data_parallel),), ("data",), devices)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, ``(16, 16)`` over ``('data',
    'model')`` or ``(2, 16, 16)`` over ``('pod', 'data', 'model')``, its
    devices ``meta`` placeholders."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, ["meta"] * int(np.prod(shape)))


def make_dryrun_mesh(*, multi_pod: bool = False, shape=None) -> Mesh:
    """The production mesh (``make_production_mesh``'s shapes; ``shape``
    overrides them, e.g. ``(2, 4)``, with the same axis names) over a
    ``DeviceMesh`` on the ``fake`` process group, this process rank 0 of
    one rank per device: DTensor placements, local shapes and
    collectives' sizes are those of rank 0, and no collective moves data.

    Starts the fake group (or restarts it at another world size), so call
    it only in a process of its own (``python -m
    repro_torch.launch.dryrun``, or a test's subprocess): the default
    process group it leaves would be seen by everything later in that
    process.  Refuses to run when a real process group is initialised."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    shape = tuple(int(s) for s in shape)
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    n = int(np.prod(shape))
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()!r} process group is initialised: the "
                "dry-run's fake group must run in a process of its own")
        if dist.get_world_size() != n:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), world_size=n,
                                rank=0)
    dm = init_device_mesh("cpu", shape, mesh_dim_names=axes)
    return Mesh(np.array([torch.device("meta")] * n, dtype=object
                         ).reshape(shape), axes, device_mesh=dm)
