"""Paged storage for the SWAN sparse cache: memory follows live tokens.

Port of ``repro.core.paged_cache``.  The slab layout reserves
``[B, Kv, max_seq, k_max]`` sparse rows per slot; here the per-layer sparse
sides become one shared pool of fixed-size pages,

  pool side (per layer; the model stacks L in front):
    vals  [n_pages, Kv, page_size, k_max]   (cfg dtype / int8 / fp8)
    idx   [n_pages, Kv, page_size, k_max]   int8   (topk mode)
    scale [n_pages, Kv, page_size]          f32    (int8 quant)

addressed through an int32 page table ``[n_slots, max_seq // page_size]``:
sparse position ``t`` of slot ``s`` lives at page ``table[s, t // ps]``,
row ``t % ps``.  Physical page 0 is the trash page (never allocated):
unmapped table entries point there, so garbage writes and gathers of
not-yet-live pages are harmless.  One physical page id backs the same
logical page in every layer and on both sides.

  bytes/page = 2 · L_attn · Kv · page_size · per_vec(k_max)      (Eq. 1 rows)

Unlike the reference (pure functions with ``mode="drop"`` scatters), the
writes here update the pool IN PLACE (functions ending in ``_``) and
redirect what must not land to the trash page; index writes that collide
do so only on the trash page, where any winner is fine.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core.hybrid_cache import (_bits, chunk_evict_winnow,
                                           decode_evict_winnow,
                                           packed_side, packed_vector_bytes,
                                           write_lanes_)
from repro_torch.models.common import torch_dtype

Params = Dict[str, Any]

TRASH_PAGE = 0          # physical page 0, never allocated (runtime.page_pool)


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

def init_paged_pool(cfg, swan, n_pages: int, page_size: int, device,
                    lead: Tuple[int, ...] = ()) -> Params:
    """Allocate one layer's page pool, both sides (``lead`` prepends e.g.
    the [L] axis of the stacked serve state)."""
    def side() -> Params:
        return packed_side(cfg, swan, (*lead, n_pages, cfg.n_kv_heads,
                                       page_size), device)

    return {"k": side(), "v": side()}


def page_bytes(cfg, swan, page_size: int) -> int:
    """Bytes committed by mapping ONE physical page (all layers, both
    sides): ``page_size`` rows of the Eq. 1 packed payload."""
    return (2 * cfg.n_layers * cfg.n_kv_heads * page_size
            * packed_vector_bytes(cfg, swan))


def ring_bytes(cfg, swan, batch: int) -> int:
    """Dense ring buffers + positions (per slot, not paged)."""
    buf = (2 * cfg.n_layers * batch * cfg.n_kv_heads * swan.buffer
           * cfg.d_head * torch_dtype(cfg.dtype).itemsize)
    return buf + cfg.n_layers * batch * swan.buffer * 4        # buf_pos


# ---------------------------------------------------------------------------
# Writes (in place)
# ---------------------------------------------------------------------------

def _pool_write_at_(side: Params, packed: Params, phys: torch.Tensor,
                    row: torch.Tensor) -> None:
    """Write packed single vectors [B, Kv, 1, ...] at per-sequence physical
    (page, row) addresses [B]."""
    p, r = phys.long(), row.long()
    for name in ("vals", "idx", "scale"):
        if name in side:
            _bits(side[name])[p, :, r] = _bits(
                packed[name][:, :, 0].to(side[name].dtype))


def paged_insert_decode_(cache: Params, swan, k_hat: torch.Tensor,
                         v_hat: torch.Tensor, pos: torch.Tensor,
                         page_tab: torch.Tensor, k_act=None) -> Params:
    """One decode step against the paged cache, in place: the slab path's
    eviction and ring mechanics (``decode_evict_winnow``), with the sparse
    write indirected through ``page_tab [B, Pg]``: sparse position ``t``
    -> (page_tab[b, t // ps], t % ps).  Dead lanes (pos < 0) keep their
    ring and write to the trash page."""
    ps = cache["pool"]["k"]["vals"].shape[2]
    write_idx, packed_k, packed_v, ring = decode_evict_winnow(
        cache, swan, k_hat, v_hat, pos, k_act)
    write_idx = torch.clamp(write_idx, min=0)      # b=0 path passes raw pos
    logical = torch.clamp(write_idx // ps, max=page_tab.shape[1] - 1).long()
    phys = torch.gather(page_tab, 1, logical[:, None])[:, 0]
    phys = torch.where(pos >= 0, phys, torch.full_like(phys, TRASH_PAGE))
    row = write_idx % ps
    _pool_write_at_(cache["pool"]["k"], packed_k, phys, row)
    _pool_write_at_(cache["pool"]["v"], packed_v, phys, row)
    if ring is not None:
        slot, rk, rv, rp = ring
        bi = torch.arange(slot.shape[0], device=slot.device)
        cache["buf_k"][bi, :, slot] = rk
        cache["buf_v"][bi, :, slot] = rv
        cache["buf_pos"][bi, slot] = rp
    return cache


def _pool_write_rows_(side: Params, packed: Params, phys: torch.Tensor,
                      row: torch.Tensor) -> None:
    """Write packed vectors [P, Kv, S, ...] at physical (page, row)
    addresses ``phys``/``row`` [P, S] (live lanes own disjoint pages; the
    only collisions are on the trash page)."""
    p, r = phys.long(), row.long()
    for name in ("vals", "idx", "scale"):
        if name in side:
            _bits(side[name])[p, :, r] = _bits(
                packed[name].transpose(1, 2).to(side[name].dtype))


def paged_insert_prefill_chunk_(cache: Params, swan, k_hat: torch.Tensor,
                                v_hat: torch.Tensor, start, true_len,
                                page_rows: torch.Tensor, k_act=None,
                                dead=None) -> Params:
    """Insert prefill chunks ([P, S, Kv, dh], lane ``p`` at positions
    [start_p, start_p + true_len_p)) through the lanes' page-table rows
    ``page_rows [P, Pg]``: the pool is written in place, the lanes' new
    rings replace ``cache``'s ring entries (the lane dict of the batched
    chunk path).  Positions past the shipped prefix or on unmapped pages
    write to the trash page (overshoot that later chunks rewrite); ``dead
    [P]`` lanes write to the trash page outright."""
    ps = cache["pool"]["k"]["vals"].shape[2]
    Pg = page_rows.shape[1]
    dest, packed_k, packed_v, ring = chunk_evict_winnow(
        cache, swan, k_hat, v_hat, start, true_len, k_act)
    S = packed_k["vals"].shape[2]
    tok = dest[:, None].long() + torch.arange(S, device=dest.device)[None]
    logical = tok // ps
    phys = torch.gather(page_rows.long(), 1, torch.clamp(logical, max=Pg - 1))
    phys = torch.where(logical < Pg, phys, torch.full_like(phys, TRASH_PAGE))
    if dead is not None:
        phys = torch.where(dead[:, None], torch.full_like(phys, TRASH_PAGE),
                           phys)
    row = tok % ps
    _pool_write_rows_(cache["pool"]["k"], packed_k, phys, row)
    _pool_write_rows_(cache["pool"]["v"], packed_v, phys, row)
    cache.update(ring)
    return cache


def _scatter_side_(pool_side: Params, slot_side: Params,
                   phys_rows: torch.Tensor, page_size: int) -> None:
    """Scatter ONE slot's slab-layout sparse side [L, 1, Kv, S, ...] into
    the pool [L, n_pages, ...] at physical pages ``phys_rows [S // ps]``.
    Every logical page is written; unmapped ones land on the trash page."""
    p = torch.as_tensor(phys_rows, device=pool_side["vals"].device).long()
    for name in ("vals", "idx", "scale"):
        if name not in pool_side:
            continue
        x = slot_side[name]
        L, _, Kv, S = x.shape[:4]
        extra = tuple(x.shape[4:])
        pages = x[:, 0].reshape((L, Kv, S // page_size, page_size) + extra) \
                       .transpose(1, 2)                    # [L, P, Kv, ps, ...]
        _bits(pool_side[name])[:, p] = _bits(pages.to(pool_side[name].dtype))


def paged_insert_prefill_(state: Params, one: Params, slot,
                          phys_rows: torch.Tensor, page_size: int) -> Params:
    """Admit a batch=1 prefilled slab state into the paged batched state, in
    place: ring leaves go to lane ``slot`` (an int or a device tensor;
    ``slot = n_slots`` parks the insert and the ring writes drop); the
    sparse sides scatter page-wise into the pool at the slot's physical
    pages (all the trash page for a parked insert)."""
    for s in ("k", "v"):
        _scatter_side_(state["pool"][s], one[s], phys_rows, page_size)
    for leaf in ("buf_k", "buf_v", "buf_pos"):
        x = state[leaf]
        write_lanes_(x.movedim(1, 0), one[leaf].movedim(1, 0),
                     torch.as_tensor(slot, device=x.device).reshape(1))
    return state
