"""SWAN cache accounting (paper Eq. 1) for the whole model.

The port's own copy of the part of ``repro.core.analytical`` that the
serve loop's cache report reads.
"""
from __future__ import annotations

from dataclasses import dataclass


def sparse_vector_bytes(k_active: int, bits8: bool = False) -> float:
    """Paper Eq. 1: 3k+2 bytes (fp16 vals + int8 idx + offset), 2k+2 for 8-bit."""
    return (2 * k_active + 2) if bits8 else (3 * k_active + 2)


@dataclass(frozen=True)
class CacheFootprint:
    dense_bytes: int
    swan_bytes: int

    @property
    def saving(self) -> float:
        return 1.0 - self.swan_bytes / self.dense_bytes


def model_cache_footprint(cfg, swan, batch: int, seq: int) -> CacheFootprint:
    """KV memory for the whole (all-attention) model, dense vs SWAN hybrid."""
    n_attn = cfg.n_layers
    itemsize = 2
    dense = 2 * n_attn * batch * cfg.n_kv_heads * seq * cfg.d_head * itemsize
    per_vec = sparse_vector_bytes(swan.k_max, swan.quantize)
    hist = max(seq - swan.buffer, 0)
    buf = min(seq, swan.buffer)
    swan_b = 2 * n_attn * batch * cfg.n_kv_heads * (
        hist * per_vec + buf * cfg.d_head * itemsize)
    return CacheFootprint(int(dense), int(swan_b))
