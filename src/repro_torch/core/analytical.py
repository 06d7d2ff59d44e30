"""SWAN analytical models: memory (Eq. 1), FLOPs and the break-even point
(Eq. 2, Appendix A.2), and the whole-model cache accounting.

The port's own copy of ``repro.core.analytical``: the serve loop's cache
report and the analytical benches (Fig. 2a, Eq. 2, memory footprint)
read it.
"""
from __future__ import annotations

from dataclasses import dataclass


# ---------------------------------------------------------------------------
# Eq. 1 — memory per sparse vector
# ---------------------------------------------------------------------------

def sparse_vector_bytes(k_active: int, bits8: bool = False) -> float:
    """Paper Eq. 1: 3k+2 bytes (fp16 vals + int8 idx + offset), 2k+2 for 8-bit."""
    return (2 * k_active + 2) if bits8 else (3 * k_active + 2)


def dense_vector_bytes(d_head: int, itemsize: int = 2) -> int:
    return d_head * itemsize


def compression_ratio(k_active: int, d_head: int, bits8: bool = False) -> float:
    """Fraction of dense size used by the sparse representation (<1 = saving)."""
    return sparse_vector_bytes(k_active, bits8) / dense_vector_bytes(d_head)


def memory_breakeven_retention(d_head: int, bits8: bool = False) -> float:
    """Retention ratio k/d_h at which sparse == dense (paper: ~0.66 @ fp16)."""
    per_dim = 2 if bits8 else 3
    return (2 * d_head - 2) / (per_dim * d_head)


# ---------------------------------------------------------------------------
# Eq. 2 / Appendix A.2 — FLOPs
# ---------------------------------------------------------------------------

def flops_standard(L: int, d_head: int) -> int:
    """C_std ≈ 4·L·d_h (Prop. A.3): score + output matvecs for one head."""
    return 4 * L * d_head


def flops_swan(L: int, d_head: int, k_active: int, b: int) -> int:
    """C_SWAN ≈ 4·d_h² + 4·(L−b)·k + 4·b·d_h (Prop. A.4)."""
    hist = max(L - b, 0)
    dense = min(L, b)
    return 4 * d_head * d_head + 4 * hist * k_active + 4 * dense * d_head


def breakeven_length(d_head: int, k_active: int, b: int) -> float:
    """Prop. A.5: SWAN is cheaper for L > d_h²/(d_h−k) + b."""
    if k_active >= d_head:
        return float("inf")
    return d_head * d_head / (d_head - k_active) + b


# ---------------------------------------------------------------------------
# Whole-model cache accounting
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CacheFootprint:
    dense_bytes: int
    swan_bytes: int

    @property
    def saving(self) -> float:
        return 1.0 - self.swan_bytes / self.dense_bytes


def model_cache_footprint(cfg, swan, batch: int, seq: int) -> CacheFootprint:
    """KV memory for the whole model (its attention layers), dense vs SWAN
    hybrid."""
    n_attn = sum(1 for i in range(cfg.n_layers) if cfg.layer_kind(i) == "attn")
    itemsize = 2
    dense = 2 * n_attn * batch * cfg.n_kv_heads * seq * cfg.d_head * itemsize
    per_vec = sparse_vector_bytes(swan.k_max, swan.quantize)
    hist = max(seq - swan.buffer, 0)
    buf = min(seq, swan.buffer)
    swan_b = 2 * n_attn * batch * cfg.n_kv_heads * (
        hist * per_vec + buf * cfg.d_head * itemsize)
    return CacheFootprint(int(dense), int(swan_b))
