"""Array pytrees (nested dicts of numpy-convertible leaves) to torch tensors.

Carries params from ``get_model(cfg).init_params``, projections and caches
of the JAX reference across to the port with the same nesting; stacked
``[L, ...]`` layer leaves stay stacked, and so do an encoder-decoder's
``enc``/``dec`` subtrees with their positional tables, its cross
attention and its biases, a hybrid's ``groups/pos{p}`` subtrees stacked
[G, ...] over its layer groups, and an RWKV model's time and channel
mixes.  Any leaf that ``np.asarray``
accepts works, so this module needs nothing of JAX.  ``bfloat16`` and
``float8_e4m3fn`` numpy arrays (ml_dtypes) are moved bit for bit, and a
0-d leaf (an optimizer's step counter) stays 0-d.  Empty dicts (the
norms of ``nonparam_ln``) stay empty, and a tied tree (no ``head``) stays
tied.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

# numpy dtypes torch.from_numpy does not know, by name -> (bit view, torch dtype)
_BIT_VIEWS = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
}


def array_to_torch(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a, order="C")      # (ascontiguousarray makes 0-d 1-d)
    bits = _BIT_VIEWS.get(arr.dtype.name)
    if bits is None:
        t = torch.from_numpy(arr.copy())
    else:
        t = torch.from_numpy(arr.view(bits[0]).copy()).view(bits[1])
    return t.to(device)


def to_torch(tree: Any, device: DeviceLike = None) -> Any:
    """Same nesting, every leaf a tensor on ``device`` (the card by
    default), with the leaf's dtype."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: to_torch(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, dev) for v in tree)
    return array_to_torch(tree, dev)
