"""Beyond-paper extension: adaptive per-layer retention allocation.

The port's own copy of ``repro.core.adaptive`` (numpy only).

The paper uses one global k_active.  But the calibration SVD already
exposes how fast each layer's spectrum decays: layers whose energy
concentrates in few dims tolerate aggressive pruning, flat-spectrum layers
do not.  ``allocate_k`` water-fills a global budget (avg_k · L) across
layers by keeping the globally-largest eigenvalues — per-layer k falls out
of the counts.

Deployment uses the runtime-tunability mechanism (per-layer k_active ≤
k_max zero-masks the packed tail), so adaptive allocation needs NO shape
changes and can be toggled per request — it composes with everything else.
Benchmarked against uniform allocation in
``repro_torch.benchmarks.bench_adaptive_k``.
"""
from __future__ import annotations

import numpy as np


def spectra_from_joint(s_eigvals) -> np.ndarray:
    """[L, Kv, dh] descending eigenvalues -> per-layer spectrum [L, dh]
    (mean over KV heads, normalised per layer)."""
    if hasattr(s_eigvals, "detach"):             # a tensor, maybe on the card
        s_eigvals = s_eigvals.detach().cpu().numpy()
    e = np.asarray(s_eigvals, np.float64).mean(axis=1)
    e = np.maximum(e, 0.0)
    return e / np.maximum(e.sum(axis=1, keepdims=True), 1e-30)


def allocate_k(spectrum: np.ndarray, avg_k: int, k_min: int = 1,
               k_max: int | None = None) -> np.ndarray:
    """Water-fill a global budget of avg_k·L retained dims across layers.

    spectrum: [L, dh] per-layer normalised eigenvalues (descending).
    Returns k per layer [L] (ints in [k_min, k_max], sum == avg_k·L when
    feasible)."""
    L, dh = spectrum.shape
    k_max = k_max or dh
    budget = avg_k * L
    k = np.full(L, k_min, np.int64)
    budget -= k.sum()
    if budget < 0:
        raise ValueError("budget below k_min per layer")
    # marginal value of the next dim for each layer = its next eigenvalue
    flat = []
    for li in range(L):
        for j in range(k_min, k_max):
            flat.append((spectrum[li, j], li))
    flat.sort(reverse=True)
    for val, li in flat:
        if budget == 0:
            break
        if k[li] < k_max:
            k[li] += 1
            budget -= 1
    return k.astype(np.int32)


def uniform_k(n_layers: int, k: int) -> np.ndarray:
    return np.full(n_layers, k, np.int32)
