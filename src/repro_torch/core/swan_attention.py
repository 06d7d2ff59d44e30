"""SWAN attention over the hybrid cache (paper Algorithm 1, 13-17).

Port of the pure path of ``repro.core.swan_attention``:

  scores = [ q̂ · expand(sparse) ‖ q̂ · buffer ] ;  o = softmax(scores) · V

Decode computes it as a gather over q̂ at the packed indices (score side)
and a scatter-add (value side), so no dense [S, dh] tensor is
materialised; the chunked-prefill bulk read (``_sparse_stats_bulk``)
expands each packed vector once for a chunk's many queries.  The paged
reads gather the pool's pages into each sequence's logical view first
(``paged_logical_view``).  This is the CPU path and the second oracle of the
kernels (``repro_torch.kernels.swan_decode`` and ``.swan_chunk``); the serve
path takes a kernel when the cache lives on the card
(``repro_torch.kernels.dispatch``).  Split-S over a mesh axis
(``_sparse_stats_sharded``, the flash-decoding schedule) is a schedule of
this plain read; a cache on the card goes through the kernel instead,
itself split-S over the sequence, since the mesh lies on one device.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.hybrid_cache import _bits, per_seq_pos, sparse_len
from repro_torch.core.winnow import unpack_dense
from repro_torch.sharding.api import one_device, shard

Params = Dict[str, Any]


def _deq(side: Params) -> torch.Tensor:
    """Packed values ready for the contractions (storage dtype; int8 is
    dequantized to f32, fp8 widened to bf16 as in the reference)."""
    vals = side["vals"]
    if "scale" in side:
        return vals.float() * side["scale"].float()[..., None]
    if vals.dtype == torch.float8_e4m3fn:
        return vals.to(torch.bfloat16)
    return vals


def _sparse_stats(qf: torch.Tensor, k_side: Params, v_side: Params, swan,
                  sp_len: torch.Tensor, s_offset: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial softmax statistics over the sparse cache.

      scores[t] = Σ_j k_vals[t,j] · q̂[k_idx[t,j]]            (gather over q̂)
      o[d]      = Σ_t Σ_j (p[t]·v_vals[t,j]) δ[v_idx[t,j]=d]  (scatter-add)

    ``sp_len`` [B] masks each sequence's valid prefix; the sides may be a
    slice of the sequence starting at ``s_offset``.  Returns (m [B,Kv,G],
    l [B,Kv,G], o_unnorm [B,Kv,G,dh]) with m = 0 on an empty prefix."""
    B, Kv, G, dh = qf.shape
    S = k_side["vals"].shape[2]
    k_max = swan.k_max
    scale = 1.0 / math.sqrt(dh)
    trunc = "idx" not in k_side

    kv_ = _deq(k_side)                                 # [B,Kv,S,k]
    vv_ = _deq(v_side)
    if trunc:
        s_sp = torch.einsum("bjgk,bjtk->bjgt",
                            qf[..., :k_max].to(kv_.dtype).float(),
                            kv_.float()) * scale
    else:
        # gather q̂ in the CACHE dtype, contract in f32
        kidx = k_side["idx"].long()[:, :, None].expand(B, Kv, G, S, k_max)
        q_b = qf.to(kv_.dtype)[:, :, :, None, :].expand(B, Kv, G, S, dh)
        q_at = torch.gather(q_b, -1, kidx)             # [B,Kv,G,S,k]
        s_sp = (q_at.float() * kv_.float()[:, :, None]).sum(-1) * scale
    valid = ((s_offset + torch.arange(S, device=qf.device))[None, None, None]
             < sp_len[:, None, None, None])
    s_sp = s_sp.masked_fill(~valid, -math.inf)

    m = s_sp.amax(-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s_sp - m_safe[..., None]).masked_fill(~valid, 0.0)
    l = p.sum(-1)

    if trunc:
        o = torch.einsum("bjgt,bjtk->bjgk", p.to(vv_.dtype).float(),
                         vv_.float())
        o = torch.nn.functional.pad(o, (0, dh - k_max))
    else:
        w = p[..., None] * vv_.float()[:, :, None]     # [B,Kv,G,S,k]
        vidx = v_side["idx"].long()[:, :, None].expand(B, Kv, G, S, k_max)
        o = torch.zeros((B, Kv, G, dh), dtype=torch.float32, device=qf.device)
        o.scatter_add_(-1, vidx.reshape(B, Kv, G, S * k_max),
                       w.reshape(B, Kv, G, S * k_max))
    return m_safe, l, o


def _sparse_stats_sharded(qf: torch.Tensor, cache: Params, swan,
                          sp_len: torch.Tensor, mesh, seq_axis: str
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split-S across ``seq_axis``: each shard's local stats over its
    sequence slice at its offset, then the O(dh) stats merged (the
    reference's one pmax + two psums).  On a mesh laid over one device the
    shards' stats stack on a shard axis and the merge is a max and two
    sums over it; the batch needs no split there.  A mesh that carries a
    ``DeviceMesh`` (the dry-run's) runs :func:`_sparse_stats_dtensor`."""
    if getattr(mesh, "device_mesh", None) is not None:
        return _sparse_stats_dtensor(qf, cache, swan, sp_len, mesh, seq_axis)
    one_device(mesh)
    S = cache["k"]["vals"].shape[2]
    n_shard = mesh.shape[seq_axis]
    s_local = S // n_shard

    def piece(side: Params, sh: int) -> Params:
        return {n: x[:, :, sh * s_local:(sh + 1) * s_local]
                for n, x in side.items()}
    m, l, o = (torch.stack(t) for t in zip(*[
        _sparse_stats(qf, piece(cache["k"], sh), piece(cache["v"], sh),
                      swan, sp_len, sh * s_local)
        for sh in range(n_shard)]))                   # [n_shard, B, Kv, G(, dh)]
    m_g = m.amax(0)
    corr = torch.exp(m - m_g)
    return m_g, (l * corr).sum(0), (o * corr[..., None]).sum(0)


def _sparse_stats_dtensor(qf: torch.Tensor, cache: Params, swan,
                          sp_len: torch.Tensor, mesh, seq_axis: str
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split-S over a ``DeviceMesh`` (``local_map``): the batch stays split
    over the other (data-parallel) axes where it divides, each device
    computes its sequence slice's stats at its offset, and an
    ``all_reduce`` max and two ``all_reduce`` sums over ``seq_axis`` merge
    them: the reference's ``shard_map`` with one pmax and two psums."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dm = mesh.device_mesh
    names = tuple(mesh.axis_names)
    seq_dim = names.index(seq_axis)
    B, S = qf.shape[0], cache["k"]["vals"].shape[2]
    s_local = S // mesh.shape[seq_axis]
    dp = [a for a in names if a != seq_axis]
    n_dp = 1
    for a in dp:
        n_dp *= mesh.shape[a]
    split_b = bool(dp) and B % n_dp == 0 and B >= n_dp

    def pl(seq_dim_of_t=None):
        return tuple(Shard(seq_dim_of_t) if a == seq_axis and seq_dim_of_t
                     is not None else Shard(0) if a != seq_axis and split_b
                     else Replicate() for a in names)
    k_names = sorted(cache["k"])
    v_names = sorted(cache["v"])
    n_k = len(k_names)

    def local_fn(q, sp, *sides):
        k_side = dict(zip(k_names, sides[:n_k]))
        v_side = dict(zip(v_names, sides[n_k:]))
        off = dm.get_local_rank(seq_dim) * s_local
        m, l, o = _sparse_stats(q, k_side, v_side, swan, sp, off)
        group = (dm, seq_dim)
        m_g = funcol.all_reduce(m, "max", group)
        corr = torch.exp(m - m_g)
        return (m_g, funcol.all_reduce(l * corr, "sum", group),
                funcol.all_reduce(o * corr[..., None], "sum", group))

    sides = [cache["k"][n] for n in k_names] + [cache["v"][n] for n in v_names]
    return local_map(local_fn, (pl(), pl(), pl()),
                     (pl(), pl()) + tuple(pl(2) for _ in sides),
                     device_mesh=dm, redistribute_inputs=True
                     )(qf, sp_len, *sides)


def swan_decode_attention(q_hat: torch.Tensor, cache: Params, swan,
                          pos: torch.Tensor, mesh=None,
                          seq_axis: Optional[str] = None) -> torch.Tensor:
    """q̂ [B, Kv, G, dh] (rotated, grouped) -> o [B, Kv, G, dh] (rotated).

    Joint exact softmax over [winnowed sparse ‖ dense buffer]; ``pos`` is
    the per-sequence decode position [B].  With ``mesh``/``seq_axis`` (an
    axis that splits the sequence evenly) the sparse part runs split-S."""
    dh = q_hat.shape[-1]
    # every device of a split-S read needs all of its sequences' heads:
    # the reference's shard_map in_spec for q (an activation hook, the
    # identity off a DTensor mesh)
    qf = shard(q_hat.float(), "decode_q")
    sp = sparse_len(swan, pos)                         # [B]
    scale = 1.0 / math.sqrt(dh)
    S = cache["k"]["vals"].shape[2]
    if (mesh is not None and seq_axis in mesh.axis_names
            and S % mesh.shape[seq_axis] == 0 and S >= mesh.shape[seq_axis]):
        m_sp, l_sp, o_sp = _sparse_stats_sharded(qf, cache, swan, sp, mesh,
                                                 seq_axis)
    else:
        m_sp, l_sp, o_sp = _sparse_stats(qf, cache["k"], cache["v"], swan,
                                         sp)

    if cache["buf_k"].shape[2] == 0:    # bt=0 ablation: sparse-only softmax
        return (o_sp / torch.clamp(l_sp, min=1e-30)[..., None]).to(q_hat.dtype)

    bk, bv = cache["buf_k"], cache["buf_v"]            # [B,Kv,b,dh]
    s_b = torch.einsum("bjgd,bjtd->bjgt", qf.to(bk.dtype).float(),
                       bk.float()) * scale
    b_valid = ((cache["buf_pos"] >= 0)
               & (cache["buf_pos"] <= pos[:, None]))[:, None, None]
    s_b = s_b.masked_fill(~b_valid, -math.inf)
    m_b = s_b.amax(-1)
    m_b = torch.where(torch.isfinite(m_b), m_b, torch.zeros_like(m_b))
    p_b = torch.exp(s_b - m_b[..., None]).masked_fill(~b_valid, 0.0)
    l_b = p_b.sum(-1)
    o_b = torch.einsum("bjgt,bjtd->bjgd", p_b.to(bv.dtype).float(),
                       bv.float())

    m = torch.maximum(m_sp, m_b)
    c_sp = torch.exp(m_sp - m)
    c_b = torch.exp(m_b - m)
    denom = torch.clamp(l_sp * c_sp + l_b * c_b, min=1e-30)
    o = (o_sp * c_sp[..., None] + o_b * c_b[..., None]) / denom[..., None]
    return o.to(q_hat.dtype)


# ---------------------------------------------------------------------------
# Chunked prefill: the bulk read of the sparse prefix
# ---------------------------------------------------------------------------

def _sparse_stats_bulk(qf: torch.Tensor, k_side: Params, v_side: Params,
                       sp_len: torch.Tensor, dh: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial softmax stats of MANY queries ``qf [B, Kv, Q, dh]`` against
    the valid prefix ``t < sp_len [B]`` of a packed sparse cache: each
    packed vector is expanded once (in the cache dtype) and both sides are
    plain dots accumulated in f32.  Returns (m_safe, l [B,Kv,Q],
    o_unnorm [B,Kv,Q,dh]), ``m_safe = 0`` where the prefix is empty."""
    S = k_side["vals"].shape[2]
    scale = 1.0 / math.sqrt(dh)
    kv_ = _deq(k_side)                                 # [B,Kv,S,k]
    vv_ = _deq(v_side)
    if "idx" in k_side:
        kd = unpack_dense(kv_, k_side["idx"], dh)      # [B,Kv,S,dh]
        s_sp = torch.einsum("bjqd,bjtd->bjqt", qf.to(kd.dtype).float(),
                            kd.float()) * scale
    else:                                              # truncate: low-rank dot
        k_max = kv_.shape[-1]
        s_sp = torch.einsum("bjqk,bjtk->bjqt",
                            qf[..., :k_max].to(kv_.dtype).float(),
                            kv_.float()) * scale
    valid = (torch.arange(S, device=qf.device)[None, None, None, :]
             < sp_len[:, None, None, None])
    s_sp = s_sp.masked_fill(~valid, -math.inf)
    m = s_sp.amax(-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s_sp - m_safe[..., None]).masked_fill(~valid, 0.0)
    l = p.sum(-1)
    if "idx" in v_side:
        vd = unpack_dense(vv_, v_side["idx"], dh)
        o = torch.einsum("bjqt,bjtd->bjqd", p.to(vd.dtype).float(), vd.float())
    else:
        o = torch.einsum("bjqt,bjtk->bjqk", p.to(vv_.dtype).float(),
                         vv_.float())
        o = torch.nn.functional.pad(o, (0, dh - vv_.shape[-1]))
    return m_safe, l, o


def swan_chunk_prefill_attention(q_hat: torch.Tensor, k_hat: torch.Tensor,
                                 v_new: torch.Tensor, cache: Params, swan,
                                 start, sparse_stats=None) -> torch.Tensor:
    """Attention of prefill CHUNKS resuming from a populated hybrid cache.

    ``q_hat [B, S, Kv, G, dh]`` / ``k_hat``, ``v_new [B, S, Kv, dh]``: lane
    ``p``'s fresh chunk at absolute positions [start_p, start_p + S) against
    ``cache`` holding its tokens [0, start_p) (slab rows or a
    ``paged_logical_view``).  One exact softmax per query over [winnowed
    sparse prefix [0, start-b) ‖ ring [start-b, start) ‖ chunk (causal)];
    ring entries are also masked to positions < start, so a freed slot's
    dirty ring never leaks into a new prompt.  ``sparse_stats``: the
    sparse prefix's (m_safe, l, o_unnorm) in the query-flattened
    [B, Kv, S·G(, dh)] layout, from the chunk-stats kernel; ``cache["k"]``
    and ``cache["v"]`` are then not read.  Returns [B, S, Kv·G, dh]."""
    B, S, Kv, G, dh = q_hat.shape
    scale = 1.0 / math.sqrt(dh)
    start = per_seq_pos(start, B, q_hat.device)                # [B]
    qf = q_hat.float().permute(0, 2, 1, 3, 4)                  # [B,Kv,S,G,dh]
    if sparse_stats is not None:
        m_sp, l_sp, o_sp = sparse_stats
    else:
        sp_len = torch.clamp(start - swan.buffer, min=0)
        m_sp, l_sp, o_sp = _sparse_stats_bulk(qf.reshape(B, Kv, S * G, dh),
                                              cache["k"], cache["v"], sp_len,
                                              dh)
    m_sp = m_sp.reshape(B, Kv, S, G)
    l_sp = l_sp.reshape(B, Kv, S, G)
    o_sp = o_sp.reshape(B, Kv, S, G, dh)

    # ---- dense side: [old ring ‖ chunk] ------------------------------------
    bkc, bvc = cache["buf_k"], cache["buf_v"]
    bk = torch.cat([bkc, k_hat.transpose(1, 2).to(bkc.dtype)], dim=2)
    bv = torch.cat([bvc, v_new.transpose(1, 2).to(bvc.dtype)], dim=2)
    qpos = start[:, None] + torch.arange(S, device=q_hat.device)[None]  # [B,S]
    kpos = torch.cat([cache["buf_pos"], qpos.to(cache["buf_pos"].dtype)], 1)
    in_seq = torch.cat([cache["buf_pos"] < start[:, None],
                        torch.ones((B, S), dtype=torch.bool,
                                   device=q_hat.device)], dim=1)  # [B, b+S]
    valid = ((kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[:, :, None])
             & in_seq[:, None, :])                             # [B, S, b+S]
    valid = valid[:, None, :, None, :]                          # [B,1,S,1,b+S]
    s_b = torch.einsum("bjsgd,bjtd->bjsgt", qf.to(bk.dtype).float(),
                       bk.float()) * scale
    s_b = s_b.masked_fill(~valid, -math.inf)
    m_b = s_b.amax(-1)
    m_b = torch.where(torch.isfinite(m_b), m_b, torch.zeros_like(m_b))
    p_b = torch.exp(s_b - m_b[..., None]).masked_fill(~valid, 0.0)
    l_b = p_b.sum(-1)
    o_b = torch.einsum("bjsgt,bjtd->bjsgd", p_b.to(bv.dtype).float(),
                       bv.float())

    # ---- exact merge ---------------------------------------------------------
    m = torch.maximum(m_sp, m_b)
    c_sp = torch.exp(m_sp - m)
    c_b = torch.exp(m_b - m)
    denom = torch.clamp(l_sp * c_sp + l_b * c_b, min=1e-30)
    o = (o_sp * c_sp[..., None] + o_b * c_b[..., None]) / denom[..., None]
    return o.permute(0, 2, 1, 3, 4).reshape(B, S, Kv * G, dh).to(q_hat.dtype)


# ---------------------------------------------------------------------------
# Paged cache: gather-via-page-table reads
# ---------------------------------------------------------------------------

def gather_pages(x: torch.Tensor, page_tab: torch.Tensor) -> torch.Tensor:
    """Pool leaf [n_pages, Kv, ps, ...] -> each sequence's logical rows
    [B, Kv, Pg·ps, ...] through ``page_tab [B, Pg]``:
    ``out[b, :, t] = x[page_tab[b, t // ps], :, t % ps]``."""
    B, Pg = page_tab.shape
    v = _bits(x)[page_tab.long()]                       # [B, Pg, Kv, ps, ...]
    v = v.movedim(2, 1)                                 # [B, Kv, Pg, ps, ...]
    v = v.reshape(B, v.shape[1], Pg * v.shape[3], *v.shape[4:])
    return v.view(x.dtype) if v.dtype != x.dtype else v


def paged_logical_view(cache: Params, page_tab: torch.Tensor) -> Params:
    """Each sequence's logical sparse cache assembled from the shared page
    pool (a page-granule gather of the PACKED payload; unmapped pages
    gather the trash page, hidden by ``sp_len``).  ``page_tab`` may be a
    leading prefix of the full table."""
    view: Params = {s: {n: gather_pages(x, page_tab)
                        for n, x in cache["pool"][s].items()}
                    for s in ("k", "v")}
    for n in ("buf_k", "buf_v", "buf_pos"):
        view[n] = cache[n]
    return view


def swan_decode_attention_paged(q_hat: torch.Tensor, cache: Params, swan,
                                pos: torch.Tensor, page_tab: torch.Tensor,
                                mesh=None, seq_axis: Optional[str] = None
                                ) -> torch.Tensor:
    """SWAN decode attention over the paged cache: page-table gather, then
    the slab layout's joint softmax (token-identical to the slab)."""
    return swan_decode_attention(q_hat, paged_logical_view(cache, page_tab),
                                 swan, pos, mesh=mesh, seq_axis=seq_axis)


# ---------------------------------------------------------------------------
# Oracle: full decompression + dense softmax (tests only, never serving)
# ---------------------------------------------------------------------------

def swan_decode_attention_reference(q_hat: torch.Tensor, cache: Params, swan,
                                    pos) -> torch.Tensor:
    B, Kv, G, dh = q_hat.shape
    S = cache["k"]["vals"].shape[2]
    pos = per_seq_pos(pos, B, q_hat.device)

    def side_dense(side):
        vals = side["vals"].float()
        if "scale" in side:
            vals = vals * side["scale"].float()[..., None]
        return unpack_dense(vals, side.get("idx"), dh)

    kd, vd = side_dense(cache["k"]), side_dense(cache["v"])
    qf = q_hat.float()
    s_sp = torch.einsum("bjgd,bjtd->bjgt", qf, kd) / math.sqrt(dh)
    sp_valid = (torch.arange(S, device=q_hat.device)[None, :]
                < sparse_len(swan, pos)[:, None])
    s_sp = s_sp.masked_fill(~sp_valid[:, None, None], -math.inf)
    s_b = torch.einsum("bjgd,bjtd->bjgt", qf,
                       cache["buf_k"].float()) / math.sqrt(dh)
    b_valid = (cache["buf_pos"] >= 0) & (cache["buf_pos"] <= pos[:, None])
    s_b = s_b.masked_fill(~b_valid[:, None, None], -math.inf)
    w = torch.softmax(torch.cat([s_sp, s_b], dim=-1), dim=-1)
    v_all = torch.cat([vd, cache["buf_v"].float()], dim=2)
    return torch.einsum("bjgt,bjtd->bjgd", w, v_all).to(q_hat.dtype)
