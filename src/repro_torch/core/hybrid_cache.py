"""SWAN hybrid KV cache: dense ring buffer + packed sparse history.

Port of ``repro.core.hybrid_cache`` (slab layout).  Per attention layer:

  sparse (historical, winnowed) — indexed directly by token position:
    k_vals [B, Kv, S, k_max]   (cfg dtype, int8 or float8_e4m3fn when quantized)
    k_idx  [B, Kv, S, k_max]   int8   (topk mode only)
    k_scale[B, Kv, S]          f32    (int8 only)             (same for v_*)
  buffer (recent, dense):
    buf_k / buf_v [B, Kv, b, dh]
    buf_pos [B, b] int32 — token position held in each ring slot (-1 = empty)

Token ``t`` lives in ring slot ``t % b``.  At decode step ``pos`` the slot's
previous occupant (token ``pos - b``) is winnowed and written to the sparse
cache at its own position.  While ``pos < b`` the evicted slot is empty and
the clamped write lands on row 0, which the ``sparse_len`` mask hides until a
real eviction rewrites it — the reference's mechanics, kept bit for bit.

Unlike the reference (pure functions), the inserts here update the cache
tensors IN PLACE (functions ending in ``_``); they also return the cache.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core.winnow import winnow_vector
from repro_torch.models.common import torch_dtype

Params = Dict[str, Any]


def _val_dtype(cfg, swan) -> torch.dtype:
    if swan.quantize:
        return torch.float8_e4m3fn if swan.quant_dtype == "fp8" else torch.int8
    return torch_dtype(cfg.dtype)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """Bit view for float8 tensors: indexing, ``where`` and ``zeros`` on the
    uint8 view work on every device and move the same bytes."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _zeros(shape, dtype, device) -> torch.Tensor:
    if dtype == torch.float8_e4m3fn:   # +0.0 is the all-zero byte
        return torch.zeros(shape, dtype=torch.uint8, device=device).view(dtype)
    return torch.zeros(shape, dtype=dtype, device=device)


def packed_side(cfg, swan, rows: Tuple[int, ...], device) -> Params:
    """Zeroed packed vectors of one side (k or v) over ``rows`` (e.g.
    [B, Kv, S]; the reference's ``_side``): 'vals' [*rows, k_max] in the
    value dtype, 'idx' int8 in topk mode, 'scale' f32 [*rows] with int8
    values."""
    k = swan.k_max
    d: Params = {"vals": _zeros((*rows, k), _val_dtype(cfg, swan), device)}
    if swan.mode == "topk":
        d["idx"] = torch.zeros((*rows, k), dtype=torch.int8, device=device)
    if swan.quantize and swan.quant_dtype == "int8":
        d["scale"] = torch.zeros(rows, dtype=torch.float32, device=device)
    return d


def init_swan_cache(cfg, swan, batch: int, max_seq: int, device,
                    lead: Tuple[int, ...] = ()) -> Params:
    """Allocate one layer's hybrid cache (``lead`` prepends e.g. the [L]
    axis of the stacked serve state)."""
    Kv, dh, b = cfg.n_kv_heads, cfg.d_head, swan.buffer
    cdt = torch_dtype(cfg.dtype)

    def side() -> Params:
        return packed_side(cfg, swan, (*lead, batch, Kv, max_seq), device)

    return {
        "k": side(), "v": side(),
        "buf_k": torch.zeros((*lead, batch, Kv, b, dh), dtype=cdt,
                             device=device),
        "buf_v": torch.zeros((*lead, batch, Kv, b, dh), dtype=cdt,
                             device=device),
        "buf_pos": torch.full((*lead, batch, b), -1, dtype=torch.int32,
                              device=device),
    }


def per_seq_pos(pos: Union[int, torch.Tensor], batch: int,
                device) -> torch.Tensor:
    """Normalise a scalar-or-[B] decode position to int32 [B] on ``device``
    (a python int is filled on the device: no host-to-device copy)."""
    if isinstance(pos, int):
        return torch.full((batch,), pos, dtype=torch.int32, device=device)
    return torch.as_tensor(pos, dtype=torch.int32,
                           device=device).expand(batch).contiguous()


def packed_vector_bytes(cfg, swan) -> int:
    """Physical bytes of ONE packed sparse vector in this config's dtypes."""
    k = swan.k_max
    itemsize = torch_dtype(cfg.dtype).itemsize
    per_vec = k * (1 if swan.quantize else itemsize)
    if swan.mode == "topk":
        per_vec += k                      # int8 indices
    if swan.quantize and swan.quant_dtype == "int8":
        per_vec += 4                      # f32 scale (fp8 needs none)
    return per_vec


def cache_bytes(cfg, swan, batch: int, max_seq: int) -> int:
    """Physical bytes of one layer's hybrid cache (cf. paper Eq. 1)."""
    Kv, dh, b = cfg.n_kv_heads, cfg.d_head, swan.buffer
    sparse = 2 * batch * Kv * max_seq * packed_vector_bytes(cfg, swan)
    buffer = 2 * batch * Kv * b * dh * torch_dtype(cfg.dtype).itemsize
    return sparse + buffer


def dense_cache_bytes(cfg, batch: int, max_seq: int) -> int:
    return (2 * batch * cfg.n_kv_heads * max_seq * cfg.d_head
            * torch_dtype(cfg.dtype).itemsize)


# ---------------------------------------------------------------------------
# Updates (in place)
# ---------------------------------------------------------------------------

def _write_sparse_rows_(side: Params, packed: Params, rows: slice) -> None:
    """Write packed vectors [B, Kv, n, ...] at sparse rows ``rows``."""
    _bits(side["vals"])[:, :, rows] = _bits(packed["vals"].to(side["vals"].dtype))
    for name in ("idx", "scale"):
        if name in side:
            side[name][:, :, rows] = packed[name]


def _write_sparse_at_(side: Params, packed: Params, row: torch.Tensor,
                      keep: torch.Tensor) -> None:
    """Write packed single vectors [B, Kv, 1, ...] at per-sequence rows
    ``row`` [B].  Lanes with ``keep`` set rewrite the row's own content
    (the reference drops their write out of range)."""
    bi = torch.arange(row.shape[0], device=row.device)
    r = row.long()
    for name in ("vals", "idx", "scale"):
        if name not in side:
            continue
        dst = _bits(side[name])
        new = _bits(packed[name][:, :, 0].to(side[name].dtype))
        cur = dst[bi, :, r]
        k = keep.reshape(-1, *([1] * (cur.ndim - 1)))
        dst[bi, :, r] = torch.where(k, cur, new)


def decode_evict_winnow(cache: Params, swan, k_hat: torch.Tensor,
                        v_hat: torch.Tensor, pos: torch.Tensor, k_act=None):
    """Pop each sequence's ring occupant (Algorithm 1's pop-oldest), winnow
    it, and stage the ring insert of the new token.  Reads only.

    Returns ``(write_idx [B], packed_k, packed_v, ring)``: the caller writes
    the packed vectors at ``write_idx`` and ``ring`` = (slot [B], k rows,
    v rows [B, Kv, dh], positions [B]) into the ring.  Dead lanes
    (``pos < 0``) stage their ring rows unchanged.  With ``b == 0`` the new
    token itself is winnowed at ``pos`` and ``ring`` is None."""
    B = k_hat.shape[0]
    b = swan.buffer
    if b == 0:   # winnow immediately, no ring
        return (pos, winnow_vector(k_hat.transpose(1, 2), swan, "k", k_act),
                winnow_vector(v_hat.transpose(1, 2), swan, "v", k_act), None)
    dead = pos < 0                                                  # [B]
    bi = torch.arange(B, device=pos.device)
    slot = torch.remainder(pos, b).long()                           # [B]
    old_pos = cache["buf_pos"][bi, slot]                            # [B]
    write_idx = torch.clamp(old_pos, min=0)
    old_k = cache["buf_k"][bi, :, slot]                             # [B,Kv,dh]
    old_v = cache["buf_v"][bi, :, slot]
    packed_k = winnow_vector(old_k[:, :, None], swan, "k", k_act)   # [B,Kv,1,..]
    packed_v = winnow_vector(old_v[:, :, None], swan, "v", k_act)
    keep = dead[:, None, None]
    ring = (slot,
            torch.where(keep, old_k, k_hat[:, 0].to(old_k.dtype)),
            torch.where(keep, old_v, v_hat[:, 0].to(old_v.dtype)),
            torch.where(dead, old_pos, pos))
    return write_idx, packed_k, packed_v, ring


def swan_cache_insert_decode_(cache: Params, swan, k_hat: torch.Tensor,
                              v_hat: torch.Tensor, pos: torch.Tensor,
                              k_act=None) -> Params:
    """One decode step, in place: evict+winnow each ring slot's occupant,
    insert the new rotated k̂/v̂ [B, 1, Kv, dh] at ``pos`` [B].  Dead lanes
    (pos < 0) are no-ops."""
    write_idx, packed_k, packed_v, ring = decode_evict_winnow(
        cache, swan, k_hat, v_hat, pos, k_act)
    dead = pos < 0
    row = torch.where(dead, torch.zeros_like(write_idx), write_idx)
    _write_sparse_at_(cache["k"], packed_k, row, dead)
    _write_sparse_at_(cache["v"], packed_v, row, dead)
    if ring is not None:
        slot, rk, rv, rp = ring
        bi = torch.arange(slot.shape[0], device=slot.device)
        cache["buf_k"][bi, :, slot] = rk
        cache["buf_v"][bi, :, slot] = rv
        cache["buf_pos"][bi, slot] = rp
    return cache


def swan_cache_insert_prefill_(cache: Params, swan, k_hat: torch.Tensor,
                               v_hat: torch.Tensor, k_act=None,
                               true_len=None) -> Params:
    """Bulk insert a prefill of S tokens (positions 0..S-1), in place.

    Tokens [0, S-b) are winnowed into the sparse cache; the last min(S, b)
    tokens land dense in the ring at their natural slots (t % b).
    ``true_len`` (an int or a 0-d device tensor) supports prompt-length
    bucketing: S is the padded length and only [0, true_len) are real, so
    the ring holds [true_len - b, true_len); overshoot rows past
    true_len - b stay in the invalid region (>= sp_len) until decode
    evictions rewrite them."""
    S = k_hat.shape[1]
    b = swan.buffer
    n_sp = max(S - b, 0) if b else S
    kt = k_hat.transpose(1, 2)     # [B, Kv, S, dh]
    vt = v_hat.transpose(1, 2)
    if n_sp:
        _write_sparse_rows_(cache["k"], winnow_vector(kt[:, :, :n_sp], swan,
                                                      "k", k_act),
                            slice(0, n_sp))
        _write_sparse_rows_(cache["v"], winnow_vector(vt[:, :, :n_sp], swan,
                                                      "v", k_act),
                            slice(0, n_sp))
    if b == 0:
        return cache
    if true_len is None:
        tail = torch.arange(n_sp, S, device=k_hat.device)
        src, ring_pos = tail, tail
    else:
        ar = torch.arange(b, device=k_hat.device)
        tail = (true_len.long() - b + ar if isinstance(true_len, torch.Tensor)
                else ar + (int(true_len) - b))
        src = torch.clamp(tail, 0, S - 1)
        ring_pos = torch.where(tail >= 0, tail, torch.full_like(tail, -1))
    slots = torch.remainder(tail, b)     # b consecutive ints: all residues
    cache["buf_k"][:, :, slots] = kt[:, :, src].to(cache["buf_k"].dtype)
    cache["buf_v"][:, :, slots] = vt[:, :, src].to(cache["buf_v"].dtype)
    cache["buf_pos"][:, slots] = ring_pos.to(torch.int32)
    return cache


def chunk_evict_winnow(cache: Params, swan, k_hat: torch.Tensor,
                       v_hat: torch.Tensor, start, true_len, k_act=None):
    """Bulk analogue of ``decode_evict_winnow`` for prefill CHUNKS of S
    (padded) tokens, one per lane, at positions [start_p, start_p +
    true_len_p) of a cache whose lane ``p`` holds tokens [0, start_p).
    Reads only.

    Each lane's chunk pops the positions [start - b, start + true_len - b):
    the first ``true_len`` entries of the position-ordered sequence
    [ring occupants at start-b .. start-1 ‖ chunk tokens]; the new ring
    holds the next b entries, at their natural slots, exactly where a
    monolithic ``true_len``-anchored prefill would put them.

    Returns ``(dest [B], packed_k, packed_v, ring)``: the caller commits
    each lane's S packed vectors CONTIGUOUSLY at sparse rows [dest, dest +
    S), dest = max(start - b, 0) (rows past start + true_len - b are
    overshoot that later chunks or evictions rewrite before they become
    valid), and replaces the lanes' rings with ``ring`` (new
    buf_k/buf_v/buf_pos tensors; empty with ``b == 0``)."""
    B, S = k_hat.shape[:2]
    b = swan.buffer
    dev = k_hat.device
    start = per_seq_pos(start, B, dev).long()                # [B]
    true_len = per_seq_pos(true_len, B, dev).long()
    kt = k_hat.transpose(1, 2)                               # [B, Kv, S, dh]
    vt = v_hat.transpose(1, 2)
    if b == 0:   # winnow immediately, no ring
        return (start, winnow_vector(kt, swan, "k", k_act),
                winnow_vector(vt, swan, "v", k_act), {})
    ar_b = torch.arange(b, device=dev)
    ring_order = torch.remainder(start[:, None] - b + ar_b[None], b)  # [B, b]
    bi = torch.arange(B, device=dev)[:, None]
    comb_k = torch.cat([cache["buf_k"][bi, :, ring_order].transpose(1, 2)
                        .to(kt.dtype), kt], dim=2)           # [B, Kv, b+S, dh]
    comb_v = torch.cat([cache["buf_v"][bi, :, ring_order].transpose(1, 2)
                        .to(vt.dtype), vt], dim=2)
    w_off = torch.clamp(b - start, 0, b)                     # [B]
    dest = torch.clamp(start - b, min=0)
    sel = w_off[:, None] + torch.arange(S, device=dev)[None]         # [B, S]
    packed_k = winnow_vector(comb_k[bi, :, sel].transpose(1, 2), swan, "k",
                             k_act)
    packed_v = winnow_vector(comb_v[bi, :, sel].transpose(1, 2), swan, "v",
                             k_act)
    tail = (start + true_len)[:, None] - b + ar_b[None]              # [B, b]
    slots = torch.remainder(tail, b)
    src = true_len[:, None] + ar_b[None]
    ring = {n: cache[n].clone() for n in ("buf_k", "buf_v", "buf_pos")}
    ring["buf_k"][bi, :, slots] = comb_k[bi, :, src].to(ring["buf_k"].dtype)
    ring["buf_v"][bi, :, slots] = comb_v[bi, :, src].to(ring["buf_v"].dtype)
    ring["buf_pos"][bi, slots] = torch.where(
        tail >= 0, tail, torch.full_like(tail, -1)).to(torch.int32)
    return dest, packed_k, packed_v, ring


class LaneWrites(NamedTuple):
    """A plan of P per-lane writes into batch lanes (``lane_writes``),
    computed once per dispatch and applied to every leaf of every layer
    (``apply_lane_writes_``)."""
    src: torch.Tensor               # [P] the lane whose values each carries
    keep: torch.Tensor              # [P] or [P, S]: the write lands
    lane: torch.Tensor              # [P] or [P, S]: target batch lane
    rows: Optional[torch.Tensor]    # [P, S] target rows, or None


def lane_writes(lane, n: int, start=None, S: int = 0, R: int = 0,
                device=None) -> LaneWrites:
    """How P per-lane writes into batch lanes ``lane [P]`` (``lane >= n`` is
    a dead lane) land at a shape fixed by P (and S) alone, with no two
    writes colliding on different values.  A live lane carries its own
    writes; a dead lane repeats the first live lane's (lane 0's when none
    is live), so duplicate targets always carry identical values.  With
    ``start``, lane p writes rows [start_p, start_p + S) of a lane of R
    rows; a row past R is dropped by rewriting its own content at row
    ``r - R``, below the lane's kept rows (S <= R)."""
    lane = torch.as_tensor(lane, device=device).long()
    P, dev = lane.shape[0], lane.device
    live = lane < n
    first = torch.argmax(live.int())            # 0 when no lane is live
    src = torch.where(live, torch.arange(P, device=dev), first)
    live, tgt = live[src], torch.clamp(lane[src], max=n - 1)
    if start is None:
        return LaneWrites(src, live, tgt, None)
    if S > R:
        raise ValueError(f"{S} rows per lane exceed the {R} rows of a lane")
    start = torch.as_tensor(start, device=dev).long().expand(P)
    rows = start[src][:, None] + torch.arange(S, device=dev)[None]  # [P, S]
    return LaneWrites(src, live[:, None] & (rows < R),
                      tgt[:, None].expand(P, S), torch.remainder(rows, R))


def apply_lane_writes_(dst: torch.Tensor, new: torch.Tensor,
                       plan: LaneWrites) -> None:
    """Apply ``plan`` in place as one masked read-modify-write: ``new [P,
    ...]`` into ``dst [n, ...]`` (lane writes) or ``new [P, S, X, ...]``
    into rows of ``dst [n, X, R, ...]`` (row writes)."""
    d = _bits(dst)
    idx = (plan.lane,) if plan.rows is None else (plan.lane, slice(None),
                                                  plan.rows)
    cur = d[idx]
    keep = plan.keep.reshape(*plan.keep.shape,
                             *([1] * (cur.ndim - plan.keep.ndim)))
    d[idx] = torch.where(keep, _bits(new[plan.src].to(dst.dtype)), cur)


def write_lanes_(dst: torch.Tensor, new: torch.Tensor, lane) -> None:
    """``dst[lane_p] = new[p]`` for the live lanes of ``lane [P]`` (dead
    lanes, ``lane >= dst.shape[0]``, write nothing), in place."""
    apply_lane_writes_(dst, new, lane_writes(lane, dst.shape[0],
                                             device=dst.device))


def write_sparse_rows_(side: Params, packed: Params, lane=None, dest=None,
                       plan: Optional[LaneWrites] = None) -> Params:
    """Commit packed chunk vectors [P, Kv, S, ...] at rows [dest_p, dest_p +
    S) of batch lanes ``lane [P]`` (or by a row ``plan``), in place (the
    slab commit of the batched chunked prefill); dead lanes and rows past
    the slab are dropped (``lane_writes``)."""
    if plan is None:
        plan = lane_writes(lane, side["vals"].shape[0], dest,
                           packed["vals"].shape[2], side["vals"].shape[2],
                           side["vals"].device)
    for name in ("vals", "idx", "scale"):
        if name in side:
            apply_lane_writes_(side[name], packed[name].transpose(1, 2), plan)
    return side


def sparse_len(swan, pos: torch.Tensor) -> torch.Tensor:
    """Number of valid sparse entries at decode position ``pos`` [B]."""
    return torch.clamp(pos + 1 - swan.buffer, min=0).to(torch.int32)
