"""Plain PyTorch twins of the chunk-stats kernels, with the TPU kernels'
numerics: q, the dequantised values and every sum in f32.

The slab twin is ``_sparse_stats_bulk`` on f32 operands; the pure
chunked-prefill path runs the same function on the cache's own dtype and
so differs from it only where that dtype is narrower than f32 (q is then
rounded to it before the dot).  The paged twin gathers each lane's logical
rows from the pool first (``gather_pages``).  The wrappers run the twins
for CPU tensors; the tests and ``chip_smoke.py`` hold the kernels against
them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.swan_attention import _sparse_stats_bulk, gather_pages

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _side(vals: torch.Tensor, idx: torch.Tensor,
          scale: Optional[torch.Tensor]) -> dict:
    v = vals.float()
    if scale is not None:
        v = v * scale.float()[..., None]
    return {"vals": v, "idx": idx}


def swan_chunk_stats_reference(q, k_vals, k_idx, v_vals, v_idx, sp_len,
                               k_scale=None, v_scale=None) -> Stats:
    """q [P,Kv,Q,dh]; packed sparse [P,Kv,S,k]; ``sp_len [P]``.  Returns
    (m_safe [P,Kv,Q], l [P,Kv,Q], o_unnorm [P,Kv,Q,dh]), all f32."""
    return _sparse_stats_bulk(q.float(), _side(k_vals, k_idx, k_scale),
                              _side(v_vals, v_idx, v_scale), sp_len,
                              q.shape[-1])


def swan_chunk_stats_paged_reference(q, pool_k_vals, pool_k_idx, pool_v_vals,
                                     pool_v_idx, sp_len, page_rows,
                                     pool_k_scale=None,
                                     pool_v_scale=None) -> Stats:
    """The paged twin: pool leaves [n_pages,Kv,ps,k] read through
    ``page_rows [P, Pg]``."""
    g = lambda x: None if x is None else gather_pages(x, page_rows)  # noqa: E731
    return swan_chunk_stats_reference(q, g(pool_k_vals), g(pool_k_idx),
                                      g(pool_v_vals), g(pool_v_idx), sp_len,
                                      g(pool_k_scale), g(pool_v_scale))
