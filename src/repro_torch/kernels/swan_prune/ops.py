"""The fused-winnowing entry (port of ``repro/kernels/swan_prune/ops.py:12``).

``swan_prune`` is the reference's ``ops.swan_prune``; its jit wrapper and
its ``interpret`` flag have no counterpart: the port runs eagerly, and the
device of ``x`` decides between the kernel and its plain twin.
"""
from repro_torch.kernels.swan_prune.swan_prune import swan_prune  # noqa: F401
