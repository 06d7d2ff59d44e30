"""Graph-family warmup for :class:`repro_torch.runtime.serve_engine.
ServeEngine`.

Port of ``repro.runtime.warmup``.  Under real traffic the first dispatch
of each
(prompt-chunk x lane x slab-read-prefix / page-table-prefix) shape bucket
pays a CUDA-graph capture in the middle of serving (a warm run and a
capture of a whole model step).  Every bucket is enumerable from the
engine's STATIC config, so :func:`executable_family` lists the family —
the same items, ``detail`` strings, ``expected`` counts and ``skipped``
notes as the reference — and :func:`warmup_engine` captures it at
startup, after which the engine's own dispatches capture nothing.

Warmup drives the SAME dispatch callables ``step()`` uses, with dead-lane
operands the scheduling contract already makes side-effect-free
(:func:`dead_dispatch`, which also runs on an eager engine):

* decode with every lane at ``pos = -1`` (rings untouched, slab and dense
  writes rewrite their own rows, paged writes land on the trash page);
* chunk with every lane parked off its shard (``slot = n_local``;
  ``n_slots`` at dp = 1), as ``_advance_prefills`` pads unused lanes;
  under a mesh the lane count is ``dp`` times each per-shard bucket;
* monolithic prefill into the shared single-slot transient, then the
  insert parked at ``slot = n_slots`` (ring and slab writes drop, pool
  writes land on the trash page).

``fetch`` and ``sample`` items capture nothing: a fetch item allocates the
pinned host buffers of the token fetch for one (source, lanes, rows)
bucket, a sample item runs the host sampler once on a row of the logits'
width and type.
``pool_grow`` is not warmed: growth runs eagerly, and ``_grow_pool``
drops every graph and warms the family again.

A warmup counts its captures (``repro_torch.obs.compile_events``) into
the engine's ``serve_compile_total{phase="warmup", kind=...}``, sets the
``serve_warmup_ms`` gauge and emits ``warmup_start``/``warmup_done``
trace events, as the reference does with its XLA compiles.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import paged_cache as pc
from repro_torch.obs import compile_events


@dataclass(frozen=True)
class WarmupItem:
    """One warm dispatch: a (kind, shape-bucket) the scheduler can legally
    request.  ``detail`` is the human-readable bucket key of the report."""
    kind: str                           # decode|chunk|prefill|fetch|sample
    page_bucket: Optional[int] = None   # shipped table width (paged)
    n_lanes: int = 0                    # chunk lane width (dp * Pl)
    chunk: int = 0                      # chunk token width C
    prefix: Optional[int] = None        # slab read-prefix bucket
    pad_len: int = 0                    # monolithic prompt bucket
    width: int = 0                      # fetch: temp-row gather width
    src: str = ""                       # fetch: "decode" or "chunk"

    @property
    def detail(self) -> str:
        if self.kind == "decode":
            return (f"page_bucket={self.page_bucket}"
                    if self.page_bucket is not None else "slab")
        if self.kind == "chunk":
            tail = (f"page_bucket={self.page_bucket}"
                    if self.page_bucket is not None
                    else f"prefix={self.prefix}")
            return f"lanes={self.n_lanes} C={self.chunk} {tail}"
        if self.kind == "prefill":
            return f"pad={self.pad_len}"
        if self.kind == "fetch":
            return f"{self.src} lanes={self.n_lanes} rows={self.width}"
        return self.kind


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


def _pow2_buckets(cap: int) -> List[int]:
    """Every value ``min(_pow2(x), cap)`` takes for ``x in 1..cap``: the
    powers of two up to ``cap``, plus ``cap`` itself when it is not one."""
    out: List[int] = []
    b = 1
    while b <= cap:
        out.append(b)
        b <<= 1
    if not out or out[-1] != cap:
        out.append(cap)
    return out


def executable_family(eng, max_prompt_len: Optional[int] = None
                      ) -> Dict[str, Any]:
    """Every graph bucket the scheduler can legally request from ``eng``'s
    static config: ``{"items": [WarmupItem...], "expected": {...},
    "skipped": [...]}``, ``expected`` under
    :meth:`ServeEngine.executable_census`'s keys (a fully warmed engine's
    census meets it bucket by bucket).  A fetch item follows the dispatch
    item that produces its source logits.  ``max_prompt_len`` trims the
    slab read-prefix and monolithic pad families."""
    items: List[WarmupItem] = []
    skipped: List[str] = []
    prompt_cap = min(max_prompt_len or eng.max_seq, eng.max_seq)
    prompt_pow2 = _pow2(prompt_cap)

    # --- decode family -------------------------------------------------
    if eng.paged:
        widths = _pow2_buckets(eng.pool.pages_per_seq)
        items += [WarmupItem("decode", page_bucket=w) for w in widths]
        n_decode = len(widths)
    else:
        items.append(WarmupItem("decode"))
        n_decode = 1
    # temperature-row gather over decode logits [n_slots, V]
    items += [WarmupItem("fetch", src="decode", n_lanes=eng.n_slots,
                         width=w) for w in _pow2_buckets(eng.n_slots)]

    # --- chunk family (chunked prefill) --------------------------------
    exp_chunk: Dict[str, int] = {}
    n_prefill = n_insert = n_insert_paged = 0
    if eng.prefill_chunk is not None:
        for pl in _pow2_buckets(_pow2(eng.prefill_slots)):
            lanes = eng.dp * pl
            for c in _pow2_buckets(eng.prefill_chunk):
                if eng.paged:
                    for w in _pow2_buckets(eng.pool.pages_per_seq):
                        items.append(WarmupItem(
                            "chunk", n_lanes=lanes, chunk=c, page_bucket=w))
                        exp_chunk["paged"] = exp_chunk.get("paged", 0) + 1
                else:
                    # prefix = min(pow2(start_max + C), max_seq) with
                    # start >= 0 => every pow2 bucket in [C, prompt bound]
                    for p in _pow2_buckets(eng.max_seq):
                        if p < c or p > max(prompt_pow2, c):
                            continue
                        items.append(WarmupItem(
                            "chunk", n_lanes=lanes, chunk=c, prefix=p))
                        exp_chunk[str(p)] = exp_chunk.get(str(p), 0) + 1
            items += [WarmupItem("fetch", src="chunk", n_lanes=lanes,
                                 width=w) for w in _pow2_buckets(lanes)]
    elif eng._bucketing:
        # monolithic admission: one (prefill, insert) pair per prompt
        # pad bucket
        pads = [b for b in _pow2_buckets(eng.max_seq) if b <= prompt_pow2]
        items += [WarmupItem("prefill", pad_len=b) for b in pads]
        n_prefill = len(pads)
        if eng.paged:
            n_insert_paged = len(pads)
        else:
            n_insert = len(pads)
    else:
        skipped.append(
            "monolithic prefill with bucket_prompts=False compiles once "
            "per distinct prompt length — an unbounded family warmup "
            "cannot enumerate")
    items.append(WarmupItem("sample"))

    return {
        "items": items,
        "expected": {"decode": n_decode, "prefill": n_prefill,
                     "chunk": exp_chunk, "insert": n_insert,
                     "insert_paged": n_insert_paged},
        "skipped": skipped,
    }


def dead_dispatch(eng, item: WarmupItem) -> Any:
    """Run ``item``'s dispatch (decode, chunk, or prefill + insert) on its
    dead-lane operands through the engine's dispatch path: eagerly on an
    eager engine, by graph replay (capturing the bucket first if it is
    new) on a graphed one.  Changes no live state (the trash page aside).
    Returns the dispatch's (logits, greedy ids), or None for prefill."""
    if item.kind == "decode":
        return eng._decode_call(*eng._dead_decode(), item.page_bucket)
    if item.kind == "chunk":
        return eng._chunk_call(*eng._dead_chunk(item.n_lanes, item.chunk),
                               item.page_bucket, item.prefix)
    if item.kind == "prefill":
        pad = item.pad_len
        eng._prefill_call(np.zeros((1, pad), np.int64),
                          np.asarray(eng._k_fill, np.int32),
                          np.asarray(1, np.int32))
        parked = np.asarray(eng.n_slots, np.int64)
        if eng.paged:
            n_pg = -(-pad // eng.pool.page_size)
            eng._insert_call(pad, parked,
                             np.full((n_pg,), pc.TRASH_PAGE, np.int64))
        else:
            eng._insert_call(pad, parked)
        return None
    raise ValueError(f"{item.kind!r} items dispatch nothing")


def _warm_item(eng, item: WarmupItem, last: Dict[Any, Any]
               ) -> Optional[Dict[str, Any]]:
    """Warm one item; its report row (None for a fetch item whose source
    dispatch is not in the family)."""
    c0 = compile_events.total()
    t0 = time.perf_counter()
    if item.kind == "fetch":
        src = last.get((item.src, item.n_lanes))
        if src is None:
            return None
        logits = src[0]
        eng._fetch_buffer((item.src, item.n_lanes), (item.n_lanes,),
                          src[1].dtype)
        eng._fetch_buffer((item.src, item.n_lanes, item.width),
                          (item.width, logits.shape[-1]), logits.dtype)
    elif item.kind == "sample":
        logits = last[("decode", eng.n_slots)][0]
        row = torch.zeros(logits.shape[-1:], dtype=logits.dtype)
        eng._sample(row, SimpleNamespace(temperature=1.0, seed=0), 0)
    else:
        out = dead_dispatch(eng, item)
        if out is not None:
            lanes = item.n_lanes if item.kind == "chunk" else eng.n_slots
            last[(item.kind, lanes)] = out
    return {"kind": item.kind, "detail": item.detail,
            "captures": compile_events.total() - c0,
            "ms": (time.perf_counter() - t0) * 1e3}


def warmup_engine(eng, max_prompt_len: Optional[int] = None
                  ) -> Dict[str, Any]:
    """Capture ``eng``'s whole graph family (see the module docstring).
    Returns the warmup report::

        {"warmup_ms": ..., "captures": ..., "items": [{kind, detail,
         captures, ms}...], "by_kind": {kind: {"items", "captures"}},
         "expected": <family expectation>, "census": <executable_census>,
         "skipped": [...], "note": ...}

    and records ``serve_warmup_ms`` / ``serve_compile_total{phase=
    "warmup"}`` in the engine's metrics plus ``warmup_start`` /
    ``warmup_done`` trace events.  Safe to call mid-serve (pool growth
    does): the dead-lane operands leave live sequences untouched."""
    if eng._graphs is None:
        raise RuntimeError("warmup requires graphs=True — an eager engine "
                           "has no graphs to capture")
    graphs = eng._graphs
    fam = executable_family(eng, max_prompt_len=max_prompt_len)
    t_start = time.perf_counter()
    c_start = compile_events.total()
    if eng.trace is not None:
        eng.trace.emit("warmup_start", step=eng.step_count,
                       n_items=len(fam["items"]))
    rows: List[Dict[str, Any]] = []
    last: Dict[Any, Any] = {}       # dispatch outputs per fetch source
    graphs.warming = True
    try:
        for item in fam["items"]:
            row = _warm_item(eng, item, last)
            if row is None:
                continue
            rows.append(row)
            if row["captures"]:
                eng.metrics.counter(
                    "serve_compile_total", compile_events.METRIC_HELP,
                    phase="warmup", kind=item.kind).inc(row["captures"])
    finally:
        graphs.warming = False

    by_kind: Dict[str, Dict[str, int]] = {}
    for r in rows:
        agg = by_kind.setdefault(r["kind"], {"items": 0, "captures": 0})
        agg["items"] += 1
        agg["captures"] += r["captures"]
    warmup_ms = (time.perf_counter() - t_start) * 1e3
    captures = compile_events.total() - c_start
    eng.metrics.gauge("serve_warmup_ms",
                      "wall time of the last graph-family warmup"
                      ).set(warmup_ms)
    if eng.trace is not None:
        eng.trace.emit("warmup_done", step=eng.step_count,
                       n_items=len(rows), compiles=captures,
                       warmup_ms=warmup_ms)
    return {"warmup_ms": warmup_ms, "captures": captures, "items": rows,
            "by_kind": by_kind, "expected": fam["expected"],
            "census": eng.executable_census(), "skipped": fam["skipped"],
            "note": "fetch items allocate the token fetch's pinned host "
                    "buffers and sample items run the host sampler; "
                    "neither captures a graph"}
