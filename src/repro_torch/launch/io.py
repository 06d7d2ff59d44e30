"""Concrete token batches (port of ``repro.launch.io.make_batch``).

The tokens come from ``numpy.random.default_rng(seed)`` exactly as in the
reference, so both packages see the same prompt for the same seed."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def make_batch(cfg, batch: int, seq: int, seed: int = 0,
               device: DeviceLike = None) -> Dict[str, Any]:
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq))
    return {"tokens": torch.as_tensor(tokens, dtype=torch.int64,
                                      device=resolve_device(device))}
