"""Host-side page allocator for the paged sparse KV cache.

Port of ``repro.runtime.page_pool`` (plain numpy).  The device keeps one shared pool of fixed-size pages per
layer (``repro_torch.core.paged_cache``); this module owns the mapping:
which physical page backs which (slot, logical page).  The page table is
shipped to the device as a small ``[n_slots, pages_per_seq]`` int32 operand.

Sharding (``n_shards > 1``): physical pages split into ``n_shards`` equal
blocks, slot ``s`` belongs to shard ``s // slots_per_shard`` and maps pages
only from its shard's free list; table entries are SHARD-LOCAL indices and
every shard has its own trash page 0.  ``n_shards=1`` is one pool.

Invariants (``check_consistent``):

  * local page 0 of every shard is the TRASH page: never allocated; every
    unmapped table entry points at it, so clamped garbage writes and
    gathers of not-yet-live pages land there, where validity masks hide
    them;
  * a non-trash page is owned by at most one slot at a time;
  * ``free_slot`` returns pages to the free list immediately (a request
    backfilled into the slot on the same engine step reuses them);
  * exhaustion raises ``PagePoolExhausted`` without corrupting state;
  * ``reserve`` places a HOLD for a chunked prefill's whole winnow need:
    the slot's own allocations consume it first, and no other slot may dip
    into held stock;
  * ``grow`` extends every shard's block by the same count: existing local
    indices, and so the whole table, stay valid, and the new pages join
    the BACK of each free list (warm just-freed pages are handed out first).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.paged_cache import TRASH_PAGE
from repro_torch.obs.metrics import NULL_REGISTRY, MetricsRegistry
from repro_torch.obs.trace import EventTrace


class PagePoolExhausted(RuntimeError):
    """No free physical pages left — the pool is over-committed."""


class PagePool:
    """Free-list allocator over ``n_pages`` physical pages in ``n_shards``
    equal shard blocks.  ``table[slot, j]`` is the shard-local physical page
    backing logical page ``j`` of ``slot`` (0 = unmapped / trash).  Logical
    pages are mapped densely from 0 upward."""

    def __init__(self, n_pages: int, pages_per_seq: int, n_slots: int,
                 page_size: int, n_shards: int = 1):
        if n_shards < 1:
            raise ValueError(f"n_shards={n_shards} must be >= 1")
        if n_pages % n_shards:
            raise ValueError(f"n_pages={n_pages} not divisible by "
                             f"n_shards={n_shards}")
        if n_slots % n_shards:
            raise ValueError(f"n_slots={n_slots} not divisible by "
                             f"n_shards={n_shards}")
        if n_pages // n_shards < 2:
            raise ValueError("need >= 2 pages per shard (local page 0 is "
                             "reserved as trash)")
        self.n_pages = n_pages
        self.pages_per_seq = pages_per_seq
        self.n_slots = n_slots
        self.page_size = page_size
        self.n_shards = n_shards
        self.pages_per_shard = n_pages // n_shards
        self.slots_per_shard = n_slots // n_shards
        # LIFO free lists, one per shard: a just-retired sequence's pages
        # are the next ones handed out
        self._free: List[List[int]] = [
            list(range(self.pages_per_shard - 1, 0, -1))
            for _ in range(n_shards)]
        self.table = np.full((n_slots, pages_per_seq), TRASH_PAGE, np.int32)
        self.n_mapped = np.zeros((n_slots,), np.int64)
        self._owner = np.full((n_shards, self.pages_per_shard), -1, np.int64)
        self._held = np.zeros((n_slots,), np.int64)
        # bumped on every table mutation: the engine re-uploads the device
        # table only when the mapping changed
        self.version = 0
        # observability sink (bind_obs): page map/free/exhaustion events
        # and counters, emitted on the host
        self._metrics: MetricsRegistry = NULL_REGISTRY
        self._trace: Optional[EventTrace] = None
        self._step: Callable[[], int] = lambda: 0

    def bind_obs(self, metrics: Optional[MetricsRegistry] = None,
                 trace: Optional[EventTrace] = None,
                 step_fn: Optional[Callable[[], int]] = None) -> None:
        """Attach an observability sink: ``metrics`` receives
        ``page_pool_*`` counters, ``trace`` receives ``page_map`` /
        ``page_free`` / ``pool_exhausted`` events stamped with the engine
        step from ``step_fn``.  Allocator behaviour is identical bound or
        unbound."""
        self._metrics = metrics if metrics is not None else NULL_REGISTRY
        self._trace = trace
        if step_fn is not None:
            self._step = step_fn

    def _exhausted(self, msg: str, slot: int) -> PagePoolExhausted:
        self._metrics.counter(
            "page_pool_exhausted_total",
            "allocation attempts that found no eligible free page").inc()
        if self._trace is not None:
            self._trace.emit("pool_exhausted", step=self._step(), slot=slot,
                             shard=self.shard_of(slot), detail=msg)
        return PagePoolExhausted(msg)

    def shard_of(self, slot: int) -> int:
        return slot // self.slots_per_shard

    # ------------------------------------------------------------------
    # Allocation
    # ------------------------------------------------------------------

    def pages_for(self, n_tokens: int) -> int:
        """Logical pages needed to hold ``n_tokens`` sparse tokens."""
        return -(-max(int(n_tokens), 0) // self.page_size)

    def ensure(self, slot: int, n_tokens: int) -> None:
        """Grow ``slot``'s mapping to cover ``n_tokens`` sparse tokens."""
        need = self.pages_for(n_tokens)
        if need > self.pages_per_seq:
            raise ValueError(
                f"slot {slot}: {n_tokens} tokens need {need} pages "
                f"> pages_per_seq={self.pages_per_seq}")
        while self.n_mapped[slot] < need:
            self._alloc_one(slot)

    def reserve(self, slot: int, n_pages: int) -> None:
        """Place a HOLD of ``n_pages`` for ``slot``; the caller checked the
        shard's free pages first."""
        free = self.shard_free_pages(self.shard_of(slot))
        if n_pages > free:
            raise self._exhausted(
                f"cannot hold {n_pages} pages for slot {slot}: only {free} "
                "unheld pages free on its shard", slot)
        self._held[slot] += n_pages

    def _shard_held(self, shard: int) -> int:
        lo = shard * self.slots_per_shard
        return int(self._held[lo:lo + self.slots_per_shard].sum())

    def _alloc_one(self, slot: int) -> int:
        sh = self.shard_of(slot)
        if self._held[slot] > 0:
            self._held[slot] -= 1          # consume the slot's own hold
        elif len(self._free[sh]) - self._shard_held(sh) <= 0:
            raise self._exhausted(
                f"page pool exhausted: {len(self._free[sh])} free pages on "
                f"shard {sh} all held for in-flight prefills (slot {slot} "
                "needs one more)", slot)
        if not self._free[sh]:
            raise self._exhausted(
                f"page pool exhausted: {self.pages_per_shard - 1} usable "
                f"pages on shard {sh}, all live (slot {slot} needs one more)",
                slot)
        p = self._free[sh].pop()
        if self._owner[sh, p] != -1 or p == TRASH_PAGE:
            raise RuntimeError(f"page {p} on shard {sh} is not free")
        self._owner[sh, p] = slot
        logical = int(self.n_mapped[slot])
        self.table[slot, logical] = p
        self.n_mapped[slot] += 1
        self.version += 1
        self._metrics.counter("page_pool_pages_mapped_total",
                              "physical pages mapped to slots").inc()
        if self._trace is not None:
            self._trace.emit("page_map", step=self._step(), slot=slot,
                             shard=sh, logical=logical, physical=int(p))
        return p

    def free_slot(self, slot: int) -> int:
        """Retire ``slot``: return its pages to its shard's free list and
        drop any hold.  Returns the number of pages freed."""
        sh = self.shard_of(slot)
        n = int(self.n_mapped[slot])
        for j in range(n):
            p = int(self.table[slot, j])
            self._owner[sh, p] = -1
            self._free[sh].append(p)
        self.table[slot, :] = TRASH_PAGE
        self.n_mapped[slot] = 0
        self._held[slot] = 0
        if n:
            self.version += 1
            self._metrics.counter("page_pool_pages_freed_total",
                                  "pages returned on retirement").inc(n)
        if self._trace is not None:
            self._trace.emit("page_free", step=self._step(), slot=slot,
                             shard=sh, n_pages=n)
        return n

    def grow(self, new_pages_per_shard: int) -> None:
        """Extend every shard's block to ``new_pages_per_shard`` pages; the
        caller grows the device pool to match."""
        old = self.pages_per_shard
        if new_pages_per_shard <= old:
            raise ValueError(f"grow to {new_pages_per_shard} <= current "
                             f"{old} pages per shard")
        fresh = list(range(new_pages_per_shard - 1, old - 1, -1))
        self._free = [fresh.copy() + f for f in self._free]
        self._owner = np.concatenate(
            [self._owner,
             np.full((self.n_shards, new_pages_per_shard - old), -1,
                     np.int64)], axis=1)
        self.pages_per_shard = new_pages_per_shard
        self.n_pages = new_pages_per_shard * self.n_shards

    # ------------------------------------------------------------------
    # Accounting
    # ------------------------------------------------------------------

    @property
    def live_pages(self) -> int:
        return (self.n_pages - self.n_shards
                - sum(len(f) for f in self._free))

    def shard_live_pages(self, shard: int) -> int:
        return self.pages_per_shard - 1 - len(self._free[shard])

    @property
    def free_pages(self) -> int:
        """Pages available to new claimants: free minus outstanding holds."""
        return sum(len(f) for f in self._free) - int(self._held.sum())

    def shard_free_pages(self, shard: int) -> int:
        return len(self._free[shard]) - self._shard_held(shard)

    @property
    def held_pages(self) -> int:
        return int(self._held.sum())

    def live_bytes(self, bytes_per_page: int) -> int:
        return self.live_pages * bytes_per_page

    def reserved_bytes(self, bytes_per_page: int) -> int:
        return self.n_pages * bytes_per_page

    def shard_live_bytes(self, shard: int, bytes_per_page: int) -> int:
        return self.shard_live_pages(shard) * bytes_per_page

    def shard_reserved_bytes(self, shard: int, bytes_per_page: int) -> int:
        return self.pages_per_shard * bytes_per_page

    def check_consistent(self) -> None:
        """Raise if an aliasing or accounting invariant is broken."""
        def need(ok: bool, what: str) -> None:
            if not ok:
                raise AssertionError(what)
        live = self.table[self.table != TRASH_PAGE]
        need(TRASH_PAGE not in [p for f in self._free for p in f],
             "trash page on a free list")
        need(bool((self._held >= 0).all()), "negative hold")
        for sh in range(self.n_shards):
            lo = sh * self.slots_per_shard
            rows = self.table[lo:lo + self.slots_per_shard]
            sh_live = rows[rows != TRASH_PAGE]
            need(sh_live.size == len(set(sh_live.tolist())),
                 "page aliased by 2 slots")
            need(len(self._free[sh]) + sh_live.size
                 == self.pages_per_shard - 1, "pages lost")
            need(self._shard_held(sh) <= len(self._free[sh]),
                 "holds exceed free pages")
        need(live.size == self.live_pages, "live count drifted")
        for slot in range(self.n_slots):
            sh = self.shard_of(slot)
            n = int(self.n_mapped[slot])
            need(bool((self.table[slot, :n] != TRASH_PAGE).all()),
                 "hole in a mapping")
            need(bool((self.table[slot, n:] == TRASH_PAGE).all()),
                 "mapping past n_mapped")
            need(bool((self._owner[sh, self.table[slot, :n]] == slot).all()),
                 "owner drifted")
