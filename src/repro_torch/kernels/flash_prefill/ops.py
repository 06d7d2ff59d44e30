"""The flash-attention entry (port of ``repro/kernels/flash_prefill/ops.py:20``).

``flash_attention`` is the reference's ``ops.flash_attention``; its jit
wrapper has no counterpart: the port runs eagerly.
"""
from repro_torch.kernels.flash_prefill.flash_prefill import (  # noqa: F401
    flash_attention)
