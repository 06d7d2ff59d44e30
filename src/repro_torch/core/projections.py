"""SWAN offline calibration: joint-subspace projection matrices (§4.1).

Port of ``repro.core.projections``.  For every layer and KV head:

  P_QK = right-singular basis of concat(Q_grouped, K)   (post-RoPE)
  P_VO = right-singular basis of concat(V, W_O_groupedᵀ)

computed as ``eigh`` of the Gram matrix, columns by descending eigenvalue.
Eigenvector signs (and the order inside degenerate eigenspaces) are not
fixed by ``eigh``; they may differ from the reference's, which is lossless
either way (the basis stays orthogonal).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

Params = Dict[str, Any]


def gram_basis_eigs(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P [..., d, d], eigenvalues [..., d] descending) of the Gram matrix of
    s [..., N, d] (batched over leading axes)."""
    s = s.float()
    d = s.shape[-1]
    gram = s.transpose(-1, -2) @ s
    gram = gram + 1e-6 * torch.eye(d, dtype=torch.float32, device=s.device)
    eigvals, eigvecs = torch.linalg.eigh(gram)        # ascending
    return eigvecs.flip(-1), eigvals.flip(-1)


def _group_queries(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """q [B, S, H, dh] -> [Kv, B·S·G, dh]."""
    B, S, H, dh = q.shape
    G = H // n_kv
    q = q.reshape(B, S, n_kv, G, dh)
    return q.permute(2, 0, 1, 3, 4).reshape(n_kv, B * S * G, dh)


def _group_wo(wo: torch.Tensor, n_heads: int, n_kv: int,
              d_head: int) -> torch.Tensor:
    """wo [H·dh, d] -> [Kv, G·d, dh]: per-KV-group stack of W_Oᵀ slices."""
    d = wo.shape[-1]
    G = n_heads // n_kv
    grouped = wo.reshape(n_kv, G, d_head, d)
    return grouped.permute(0, 1, 3, 2).reshape(n_kv, G * d, d_head)


def layer_projections(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      wo: torch.Tensor, n_heads: int, n_kv: int, d_head: int):
    """(P_QK, P_VO [Kv, dh, dh], spectra [Kv, dh]) for one layer.
    q: [B, S, H, dh] (post-RoPE), k/v: [B, S, Kv, dh], wo: [H·dh, d]."""
    B, S = k.shape[:2]
    qg = _group_queries(q, n_kv).float()
    kg = k.permute(2, 0, 1, 3).reshape(n_kv, B * S, d_head).float()
    vg = v.permute(2, 0, 1, 3).reshape(n_kv, B * S, d_head).float()
    wog = _group_wo(wo, n_heads, n_kv, d_head).float()
    p_qk, e_qk = gram_basis_eigs(torch.cat([qg, kg], dim=1))
    p_vo, e_vo = gram_basis_eigs(torch.cat([vg, wog], dim=1))
    return p_qk, p_vo, e_qk, e_vo


def compute_projections(qkv_per_layer, wo_per_layer: torch.Tensor,
                        n_heads: int, n_kv: int, d_head: int) -> Params:
    """qkv_per_layer: (q [L,B,S,H,dh], k/v [L,B,S,Kv,dh]); wo [L, H·dh, d].
    Returns {"p_qk", "p_vo": [L,Kv,dh,dh], "spectrum_qk", "spectrum_vo":
    [L,Kv,dh]} in float32."""
    q, k, v = qkv_per_layer
    outs = [layer_projections(q[i], k[i], v[i], wo_per_layer[i], n_heads,
                              n_kv, d_head) for i in range(q.shape[0])]
    p_qk, p_vo, e_qk, e_vo = (torch.stack(x) for x in zip(*outs))
    return {"p_qk": p_qk, "p_vo": p_vo,
            "spectrum_qk": e_qk, "spectrum_vo": e_vo}


def random_orthogonal(gen: torch.Generator, shape_prefix: Tuple[int, ...],
                      d: int) -> torch.Tensor:
    """Random orthogonal bases [*shape_prefix, d, d] (paper Table 3's
    'Random Projection' ablation): QR of standard normal matrices drawn
    from ``gen`` (on ``gen``'s device), columns signed by diag(R) so the
    draw is Haar-distributed.  Same law as the reference's, not the same
    draws."""
    n = 1
    for s in shape_prefix:
        n *= s
    g = torch.randn((n, d, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    qmat, r = torch.linalg.qr(g)
    out = qmat * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
    return out.reshape(*shape_prefix, d, d)


def check_orthogonal(p: torch.Tensor) -> float:
    """Max |PᵀP − I| over all bases in a stacked array."""
    d = p.shape[-1]
    pf = p.float()
    eye = torch.eye(d, dtype=torch.float32, device=p.device)
    return float(torch.max(torch.abs(pf.transpose(-1, -2) @ pf - eye)))
