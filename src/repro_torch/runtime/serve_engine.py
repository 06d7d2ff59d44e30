"""Continuous-batching serve engine: a shard-local slot scheduler over
batched caches.

Port of ``repro.runtime.serve_engine`` without AOT lowering
(``lower_decode`` / ``lower_chunk``).

  * a request queue (FIFO by default; ``admission="srf"`` picks the
    shortest remaining request first) feeds ``n_slots`` cache slots;
  * one decode dispatch per engine step advances ALL decoding slots at
    their own positions ``pos [B]`` (free and prefilling slots idle at
    pos = -1: their lanes compute garbage that changes nothing);
  * finished sequences free their slot at once, and the next queued
    request backfills it on the same step.

Per-request SWAN ``k`` rides along as a per-lane ``[B]`` operand, so a batch
mixes compression levels.  Prompts are padded to power-of-two buckets with
the true length alongside (the reference's compile-count bound; here the
graph-count bound).  As in the reference, both need the family's prefill
and decode to take them (``k_active``, ``true_len``): the recurrent
families (hybrid, ssm) serve at the config's k with unpadded prompts,
since a recurrent state would absorb the padding, and a graphed engine
captures their monolithic prefill once per distinct prompt length, at
first use.  Greedy lanes take the device argmax computed inside
the dispatch; temperature lanes sample on the host from the lane's f32
logits with a ``torch.Generator`` seeded from (request seed, draw index) —
they cannot reproduce the reference's ``jax.random`` draws.

Compiled dispatch (``graphs``; ``None`` = on for a CUDA device, off on the
CPU): each dispatch — decode, chunk, monolithic prefill and insert — is one
CUDA graph per shape bucket (``runtime.graphs``), the port's counterpart of
the reference's jitted executable per bucket.  Its operands are device
tensors whose shapes follow the bucket alone (decode: the page-table
width; chunk: lanes x chunk width x slab read prefix or page width;
prefill and insert: the prompt pad), and nothing inside reads a value back
to the host.  A bucket is captured at its first dispatch, or in advance by
``warmup()`` (``runtime.warmup``: the whole family the static config
allows, through dead-lane no-op operands); ``executable_census()`` counts
the graphs under the reference's keys.  ``_grow_pool`` reallocates the
pool, so it drops every graph and re-warms a warmed engine.
``async_fetch=True`` starts the decode token copy (greedy ids, and the
temperature lanes' logits rows) into pinned host memory at dispatch and
resolves it at the top of the next ``step()``, stamped with the dispatch
step: tokens, completion steps and dispatches equal the synchronous path.

Paged sparse cache (``paged=True``; SWAN only): all slots share one page
pool per layer side, addressed through the host page table
(``runtime.page_pool``): admission maps the prompt's pages, decode grows
the mapping as tokens land, retirement frees pages for immediate reuse, so
cache memory follows LIVE tokens.  Each shipped table width has one
static device buffer, refreshed when the host table changed.  An
over-committed pool holds admissions until pages free; ``pool_grow=True``
grows the device pool instead (2x pages, up to the full reservation).  The
paged engine gives the slab engine's tokens: on the card its kernels equal
the slab's bit for bit.

Chunked prefill (``prefill_chunk=C``, a power of two): a slot moves
queued -> PREFILLING -> DECODING -> retired; up to ``prefill_slots``
prefilling slots advance one chunk each per step, round-robined within the
token budget ``prefill_budget`` (default ``prefill_slots * C``) and packed
into ONE chunk dispatch (``lm_prefill_chunk_batched``) straight into the
slots' lanes of the batched state.  The lane count is bucketed to a power
of two; dead lanes park at ``slot = n_slots``.  Chunk boundaries never
depend on the schedule, so chunked == monolithic and batched == serial,
token for token.  Each engine step issues at most one chunk dispatch and
one decode dispatch (``dispatches``).  Monolithic admission prefills into
one single-slot transient shared by every prompt bucket, then inserts it.

Mesh sharding (``mesh=``, a :class:`~repro_torch.launch.mesh.Mesh` with a
``data`` axis): slots map to shards contiguously, ``slot -> (shard =
slot // n_local, lane = slot % n_local)``, and the host scheduler is
shard-local, as the reference's: admission places a request only in a
shard with a free lane (and, paged, free pages in that shard's block of
the pool: ``runtime.page_pool`` keeps one free list per shard, with
shard-local page indices and a trash page per shard), the budgeted
round-robin prefill selection runs per shard with the chunk's lanes laid
out ``[dp, P_local]``, the pool grows per shard, and retirement returns
pages to the owner's free list.  The host builds exactly the reference's
shard-local operands (lanes parked at ``n_local`` off their shard, local
page-table entries).  Every device of the mesh must be ONE device (the
CPU, or the one card): the state stays one tensor per leaf with its data
axis laid out shard-major, the pool's page axis ``dp`` blocks of
``pages_per_shard``, and each dispatch turns the local operands into the
device's rows inside its body (``sharding.api.shard_map_compat``, inside
the captured graph), so a dispatch launches each kernel once per layer
over every shard and reads the weights once, as at dp = 1; the decode
dispatch keeps dp = 1's shapes.  A mesh over distinct devices raises
``NotImplementedError`` (ROADMAP A.3, multi-card placement: the port
runs where one card is all there is, so such a path could be neither run
nor held to the reference), and a ``meta`` mesh (``make_production_mesh``)
is refused.  ``shard_params=True`` (it needs a ``model`` axis) keeps the
leaves whole: on one device the reference's gather at dispatch is the
identity.

``cache_report()`` reports ``reserved_bytes`` (allocated now), ``live_bytes``
(addressable by live tokens; equal to reserved on the slab) and, paged,
``page_table_shipped_bytes`` (the table prefix a decode dispatch ships),
with one ``shards`` entry per shard summing exactly to the totals.

Observability (``repro_torch.obs``, the reference's metric and event
names): the engine carries a ``metrics`` registry (``metrics=False`` swaps
in the no-op registry; a registry passed in is shared) and an optional
``trace`` event sink.  Every instrument is updated on the host between
dispatches from host state (Python ints, never a device tensor read
back), so metrics on vs off gives identical tokens, dispatches and
graphs.  Each dispatch records its host-side submit time (the operands'
``copy_`` and the replay, or a capture at first use; no device sync) in
``serve_dispatch_ms`` and its graph captures in
``serve_compile_total{phase="serve"}``; ``profile_steps`` brackets N
engine steps with ``torch.profiler``.  Two names differ from the
reference's (``RENAMED_FROM_REFERENCE``): the ``kernel`` label reads
``cuda`` where the hand-written kernels back a dispatch and ``torch``
for the plain path, and ``serve_pallas_dispatch_total`` is
``serve_kernel_dispatch_total``.  The port also times the monolithic
admission's prefill and insert dispatches, which the reference leaves
untimed.
"""
from __future__ import annotations

import inspect
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import hybrid_cache as hc
from repro_torch.core import paged_cache as pc
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.dispatch import kernel_supported
from repro_torch.models.registry import get_model, swan_applicable
from repro_torch.obs import compile_events
from repro_torch.obs.metrics import NULL_REGISTRY, MetricsRegistry
from repro_torch.obs.trace import EventTrace, StepProfiler
from repro_torch.runtime.graphs import GraphSet
from repro_torch.runtime.page_pool import PagePool, PagePoolExhausted
from repro_torch.runtime.sampling import sample_token
from repro_torch.runtime.serve_loop import serve_cache_report
from repro_torch.sharding.api import (P, ShardLayout, one_device,
                                      shard_map_compat)
from repro_torch.sharding.serve_specs import serve_state_pspecs
from repro_torch.sharding.specs import dp_axes

Params = Dict[str, Any]

# fixed histogram buckets, in ENGINE STEPS (the reference's values)
TTFT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
GAP_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)
REQ_STEP_BUCKETS = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
# host-side dispatch submit latency in ms, measured without a device sync
DISPATCH_MS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                       50.0, 100.0, 250.0, 1000.0, 4000.0)
# the port's names for the reference's metric family and ``kernel`` label
# values that name its kernels (Pallas) and its plain path (XLA)
RENAMED_FROM_REFERENCE = {
    "serve_pallas_dispatch_total": "serve_kernel_dispatch_total",
    "pallas": "cuda", "xla": "torch"}


@dataclass
class Request:
    """One generation request.  ``k``: optional per-request SWAN retention
    (<= swan.k_max); ``arrival_step``: engine step at which the request
    becomes visible (0 = already waiting)."""
    uid: Any
    tokens: Sequence[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    seed: int = 0
    eos: Optional[int] = None
    k: Optional[int] = None
    arrival_step: int = 0


@dataclass
class Completion:
    uid: Any
    tokens: List[int]
    prompt_len: int
    k: Optional[int]
    admitted_step: int
    finished_step: int
    first_token_step: int = -1     # engine step of the first sampled token


@dataclass
class _Slot:
    """``prefilling`` (``n_prefilled`` prompt tokens in the cache, lane pos
    = -1) -> ``decoding`` -> retired.  Monolithic admissions start at
    ``decoding``."""
    req: Request
    generated: List[int] = field(default_factory=list)
    admitted_step: int = 0
    state: str = "decoding"
    n_prefilled: int = 0
    first_token_step: int = -1
    # engine step of the latest sampled token (inter-token gap accounting)
    last_token_step: int = -1


@dataclass
class _PendingTokens:
    """A device-to-host token copy in flight: the greedy ids [N] and (with
    temperature lanes) their gathered logits rows, both landing in pinned
    host buffers, with the CUDA event that marks their arrival (None on
    the CPU, where the copies are done at once).  ``step`` is the engine
    step of the dispatch, ``lanes`` its slots (decode only)."""
    greedy: torch.Tensor          # host [N] int64
    rows: Optional[torch.Tensor]  # host [pow2(n_temp), V] or None
    temp: List[int]               # lane ids of the temperature picks
    picks: list                   # [(lane, Request, draw index)]
    step: int
    lanes: Optional[List[int]]
    event: Any


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


class ServeEngine:
    """Continuous-batching generation over a slot-based batched cache on
    ``device`` (the card unless ``device="cpu"``); ``params`` and
    ``projections`` must live there.  ``graphs`` (None: on for a CUDA
    device) dispatches through CUDA graphs; ``graphs=True`` without a
    card raises.  ``metrics``: True (a fresh registry), False (the no-op
    registry) or a registry to share; ``trace``: an event sink or None.
    Requests are token prompts: a VLM is served without patch embeddings,
    and an encoder-decoder config is refused, as in the reference.  A
    family without a paged layout or chunked prefill (hybrid, ssm) refuses
    ``paged`` and ``prefill_chunk``; its cache report is the analytic
    Eq. 1 report (attention layers only).  ``mesh`` (a mesh with a
    ``data`` axis, all its devices one device, which ``device`` must be
    when given) shards the batched state over ``data`` (see the module
    docstring); ``n_slots`` and ``n_pages`` must divide by its
    data-parallel degree ``dp``, and ``n_local = n_slots // dp`` slots
    belong to each shard."""

    def __init__(self, cfg, params, swan=None, projections=None,
                 max_seq: int = 4096, n_slots: int = 4, paged: bool = False,
                 page_size: int = 64, n_pages: Optional[int] = None,
                 bucket_prompts: bool = True,
                 prefill_chunk: Optional[int] = None, prefill_slots: int = 1,
                 prefill_budget: Optional[int] = None,
                 mesh=None, shard_params: bool = False,
                 pool_grow: bool = False, admission: str = "fifo",
                 graphs: Optional[bool] = None, async_fetch: bool = False,
                 metrics=True, trace: Optional[EventTrace] = None,
                 device: DeviceLike = None):
        if cfg.is_encoder_decoder:
            raise NotImplementedError(
                "encoder-decoder serving needs per-request encoder frames; "
                "use the lockstep ServeSession for whisper-style models")
        # --- mesh topology: slot -> (shard, lane) ----------------------
        self.mesh = mesh
        if mesh is not None:
            if "data" not in mesh.axis_names:
                raise ValueError("serve mesh needs a 'data' axis — build it "
                                 "with repro_torch.launch.mesh."
                                 "make_serve_mesh")
            self._dpx = dp_axes(mesh)
            self.dp = int(np.prod([mesh.shape[a] for a in self._dpx]))
        else:
            self._dpx = None
            self.dp = 1
        if self.dp < 1 or n_slots % self.dp:
            raise ValueError(f"n_slots={n_slots} not divisible by the "
                             f"mesh's data-parallel degree {self.dp}")
        self.n_local = n_slots // self.dp
        if shard_params and (mesh is None or "model" not in mesh.axis_names):
            raise ValueError("shard_params needs a mesh with a 'model' axis")
        if mesh is not None:
            device = one_device(mesh, device)
        self.device = resolve_device(device)
        if graphs is None:
            graphs = self.device.type == "cuda"
        self._graphs = GraphSet(self.device) if graphs else None
        compile_events.install()
        if isinstance(metrics, MetricsRegistry):
            self.metrics = metrics
        else:
            self.metrics = MetricsRegistry() if metrics else NULL_REGISTRY
        self.trace = trace
        self._profiler: Optional[StepProfiler] = None
        self.cfg = cfg
        self.api = get_model(cfg)
        self.swan = (swan if (swan and swan.enabled and swan_applicable(cfg))
                     else None)
        self.projections = projections
        self.params = params
        self.max_seq = max_seq
        self.n_slots = n_slots
        if self.swan is not None:
            self.swan.validate(cfg.d_head)
            if projections is None:
                raise ValueError("SWAN enabled but no projections given — "
                                 "run calibrate_swan first")
        if admission not in ("fifo", "srf"):
            raise ValueError(f"admission={admission!r}: 'fifo' or 'srf'")
        self.admission = admission
        self.pool_grow = pool_grow
        prefill_sig = inspect.signature(self.api.prefill).parameters
        decode_sig = inspect.signature(self.api.decode_step).parameters
        # per-request k needs a family whose prefill and decode take
        # k_active; prompt buckets need a prefill that takes true_len (a
        # recurrent state would absorb the padding)
        self._k_threading = (self.swan is not None
                             and "k_active" in prefill_sig
                             and "k_active" in decode_sig)
        self._bucketing = bucket_prompts and "true_len" in prefill_sig
        self._k_fill = 0 if self.swan is None else self.swan.k_max
        # whether the hand-written kernels back the decode and chunk reads
        # (kernels.dispatch's gate, asked for a cache on this device)
        self.use_kernels = kernel_supported(
            self.swan, torch.empty((0, 0, 1, 0), device=self.device))

        self.prefill_chunk = prefill_chunk
        if prefill_chunk is not None:
            if prefill_chunk < 1 or prefill_chunk & (prefill_chunk - 1):
                raise ValueError(f"prefill_chunk={prefill_chunk} must be a "
                                 "power of two")
            if max_seq % prefill_chunk:
                raise ValueError(f"max_seq={max_seq} not divisible by "
                                 f"prefill_chunk={prefill_chunk}")
            if self.api.prefill_chunk is None:
                raise ValueError(f"{cfg.family!r} family cannot resume a "
                                 "prefill mid-prompt (recurrent state) — "
                                 "chunked prefill unsupported")
        if prefill_slots < 1:
            raise ValueError(f"prefill_slots={prefill_slots} must be >= 1")
        if prefill_slots > 1 and prefill_chunk is None:
            raise ValueError("prefill_slots > 1 (batched concurrent "
                             "prefill) requires prefill_chunk")
        # per shard: each shard's selected lanes form its own block of the
        # packed chunk dispatch
        self.prefill_slots = min(prefill_slots, self.n_local)
        if prefill_budget is not None and prefill_budget < 1:
            raise ValueError(f"prefill_budget={prefill_budget} must be >= 1")
        if prefill_budget is not None and prefill_chunk is None:
            raise ValueError("prefill_budget requires prefill_chunk — a "
                             "monolithic admission has no per-step budget")
        self.prefill_budget = (prefill_budget if prefill_budget is not None
                               else self.prefill_slots * (prefill_chunk or 0))

        self.paged = paged
        self.pool: Optional[PagePool] = None
        if paged:
            if self.swan is None:
                raise ValueError("paged=True requires SWAN: only the sparse "
                                 "sides have a paged layout")
            if self.api.init_paged_state is None:
                raise ValueError(f"{cfg.family!r} family has no paged cache")
            if max_seq % page_size:
                raise ValueError(f"max_seq={max_seq} not divisible by "
                                 f"page_size={page_size}")
            max_pages = max_seq // page_size
            # default pool: the full per-shard reservation (+1 trash page
            # per shard) rounded up to a multiple of 8 pages per shard; a
            # smaller n_pages over-commits
            if n_pages is None:
                n_pages = self.dp * (
                    -(-(self.n_local * max_pages + 1) // 8) * 8)
            elif n_pages % self.dp:
                raise ValueError(f"n_pages={n_pages} not divisible by the "
                                 f"mesh's data-parallel degree {self.dp}")
            self.pool = PagePool(n_pages, max_pages, n_slots, page_size,
                                 n_shards=self.dp)
            self.pool.bind_obs(self.metrics, trace,
                               step_fn=lambda: self.step_count)
            self.state = self.api.init_paged_state(
                cfg, self.swan, n_slots, max_seq, n_pages, page_size,
                self.device)
        else:
            self.state = self.api.init_serve_state(cfg, self.swan, n_slots,
                                                   max_seq, self.device)
        # the slab never reallocates: its bytes are checked once here
        self._slab_bytes = None if paged else self._slab_check()

        # --- mesh placement: data-parallel compute only -----------------
        # the dispatch bodies are lane-local (no split-S stat merge), so
        # every non-data axis is stripped from the serve-state specs; on
        # one device they must describe the layout's shard-major blocks
        self._layout: Optional[ShardLayout] = None
        self._state_specs = None
        if mesh is not None:
            keep = set(self._dpx)

            def _dp_only(spec):
                return P(*[ax if (ax in keep or (isinstance(ax, tuple)
                                                 and set(ax) <= keep))
                           else None for ax in tuple(spec)])
            specs = serve_state_pspecs(self.state, mesh)
            self._state_specs = _tree_map_specs(_dp_only, specs)
            self._layout = ShardLayout(
                self.dp, self.n_local,
                self.pool.pages_per_shard if paged else 0)
            self._layout.check_specs(self.state, self._state_specs)

        self.queue: deque = deque()
        self.slots: List[Optional[_Slot]] = [None] * n_slots
        self.slot_pos = np.full((n_slots,), -1, np.int32)   # next decode pos
        self.slot_k = np.full((n_slots,), self._k_fill, np.int32)
        self.next_tok = np.zeros((n_slots,), np.int32)
        self.step_count = 0
        self.completions: List[Completion] = []
        # per-shard round-robin pointers over prefill lanes
        self._prefill_rr = [s * self.n_local for s in range(self.dp)]
        # one static device buffer per shipped page-table width, with the
        # pool version it holds (graphs read the buffer in place)
        self._tables: Dict[int, torch.Tensor] = {}
        self._table_ver: Dict[int, int] = {}
        # the monolithic admission's single-slot prefill state: graphed,
        # shared by every prompt bucket (allocated at the first admission)
        self._transient: Optional[Params] = None
        # pinned host buffers of the token fetch, keyed (source, lanes,
        # rows) as the reference's fetch family
        self._fetch_bufs: Dict[Any, torch.Tensor] = {}
        self.async_fetch = bool(async_fetch)
        self._pending: Optional[_PendingTokens] = None
        self._warmed = False
        self._warm_prompt_len: Optional[int] = None
        self.warmup_report: Optional[Dict[str, Any]] = None
        self.dispatches = {"prefill": 0, "chunk": 0, "decode": 0}

    # ------------------------------------------------------------------
    # Scheduling
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> None:
        if len(req.tokens) + req.max_new_tokens > self.max_seq:
            raise ValueError(
                f"request {req.uid}: {len(req.tokens)}+{req.max_new_tokens} "
                f"tokens exceed max_seq={self.max_seq}")
        if req.k is not None:
            if self.swan is None:
                raise ValueError(f"request {req.uid}: per-request k needs SWAN")
            if not self._k_threading:
                raise ValueError(f"{self.cfg.family!r} family does not "
                                 "support per-request k overrides")
            if req.k > self.swan.k_max:
                raise ValueError(f"request {req.uid}: k={req.k} > allocated "
                                 f"k_max={self.swan.k_max}")
        self.queue.append(req)
        self.metrics.counter("serve_requests_submitted_total",
                             "requests accepted into the queue").inc()
        if self.trace is not None:
            self.trace.emit("submit", step=self.step_count, uid=req.uid,
                            prompt_len=len(req.tokens),
                            max_new_tokens=req.max_new_tokens, k=req.k,
                            arrival_step=req.arrival_step)

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def pending(self) -> int:
        return sum(r.arrival_step <= self.step_count for r in self.queue)

    @property
    def done(self) -> bool:
        # an unresolved async token fetch still owes tokens (and maybe
        # retirements): one more step() resolves it
        return (not self.queue and self.n_active == 0
                and self._pending is None)

    # ------------------------------------------------------------------
    # Graph census and warmup
    # ------------------------------------------------------------------

    def executable_census(self) -> Dict[str, Any]:
        """Captured graphs per dispatch family, under the reference's keys:
        decode, monolithic prefill, the chunk family keyed by its slab read
        prefix (``"paged"`` for the paged family), the two admission
        inserts, and ``pool_grow`` (always empty: growth runs eagerly).
        Requires ``graphs`` (an eager engine captures nothing)."""
        if self._graphs is None:
            raise RuntimeError("executable_census requires graphs=True — "
                               "an eager engine captures no graphs")
        g = self._graphs
        chunk: Dict[str, int] = {}
        for key in g.keys("chunk"):
            bucket = "paged" if self.paged else str(key[3])
            chunk[bucket] = chunk.get(bucket, 0) + 1
        census: Dict[str, Any] = {
            "decode": g.count("decode"), "prefill": g.count("prefill"),
            "chunk": chunk, "chunk_total": sum(chunk.values()),
            "insert": g.count("insert"),
            "insert_paged": g.count("insert_paged"),
            "pool_grow": {}, "pool_grow_total": 0}
        census["total"] = (census["decode"] + census["prefill"]
                           + census["chunk_total"] + census["insert"]
                           + census["insert_paged"])
        return census

    @property
    def decode_cache_size(self) -> int:
        """Captured decode graphs; 0 for an eager engine."""
        if self._graphs is None:
            return 0
        return self.executable_census()["decode"]

    @property
    def prefill_cache_size(self) -> int:
        """Captured prefill graphs, monolithic + chunked; 0 for an eager
        engine."""
        if self._graphs is None:
            return 0
        c = self.executable_census()
        return c["prefill"] + c["chunk_total"]

    def warmup(self, max_prompt_len: Optional[int] = None) -> Dict[str, Any]:
        """Capture the engine's whole graph family before the first request
        (``runtime.warmup.warmup_engine``: dead-lane no-op dispatches
        through the same callables ``step()`` uses), so that no request
        pays a capture mid-serve.  Idempotent.  Returns the warmup report
        (also kept on ``warmup_report``); ``max_prompt_len`` trims the slab
        read-prefix and pad families."""
        from repro_torch.runtime.warmup import warmup_engine
        report = warmup_engine(self, max_prompt_len=max_prompt_len)
        self._warmed = True
        self._warm_prompt_len = max_prompt_len
        self.warmup_report = report
        return report

    # ------------------------------------------------------------------
    # Dispatches: one function per family, its operands device tensors of
    # bucket shape; eager, or one CUDA graph per bucket
    # ------------------------------------------------------------------

    def _to_device(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, non_blocking=True)
        return torch.from_numpy(np.array(x)).to(self.device,
                                                non_blocking=True)

    def _dispatch(self, family: str, key, fn: Callable, inputs: Sequence,
                  dead_inputs: Callable[[], Sequence]):
        """Run one dispatch of ``family`` (eagerly, or by graph replay) and,
        unless a warmup is capturing, record it (``_obs_dispatch``)."""
        warming = self._graphs is not None and self._graphs.warming
        c0 = compile_events.total()
        t0 = time.perf_counter()
        if self._graphs is None:
            out = fn(*[self._to_device(x) for x in inputs])
        else:
            out = self._graphs.run(family, key, fn, inputs, dead_inputs)
        if not warming:
            self._obs_dispatch(family, time.perf_counter() - t0,
                               compile_events.total() - c0)
        return out

    def _obs_dispatch(self, kind: str, dt: float, compiles: int = 0) -> None:
        """Record one dispatch: which implementation backed its SWAN read
        (``cuda`` kernels or the ``torch`` plain path), its host-side submit
        time ``dt`` in seconds (no device sync), and the graphs captured
        for it (``compiles``, the ``compile_events.total()`` delta: 0 once
        its bucket exists)."""
        kernel = ("cuda" if self.use_kernels and kind in ("decode", "chunk")
                  else "torch")
        if kernel == "cuda":
            self.metrics.counter(
                "serve_kernel_dispatch_total",
                "hot-path dispatches backed by the CUDA kernels",
                kind=kind).inc()
        self.metrics.histogram(
            "serve_dispatch_ms", DISPATCH_MS_BUCKETS,
            "host-side dispatch submit latency (no device sync)",
            kind=kind, kernel=kernel).observe(dt * 1e3)
        if compiles:
            self.metrics.counter("serve_compile_total",
                                 compile_events.METRIC_HELP,
                                 phase="serve", kind=kind).inc(compiles)

    def _decode_call(self, tok, pos, k, width: Optional[int]):
        """Decode dispatch -> (logits [n_slots, V], greedy ids [n_slots]);
        ``width``: the shipped page-table width (paged) or None."""
        tab = None if width is None else self._device_table(width)

        def body(tok, pos, k, tab):
            kw: Dict[str, Any] = {}
            if self._k_threading:
                kw["k_active"] = k
            if tab is not None:
                kw["page_tab"] = tab
            logits, _ = self.api.decode_step(self.params, self.cfg, tok, pos,
                                             self.state, self.swan,
                                             self.projections, **kw)
            return logits, torch.argmax(logits, dim=-1)
        if self._layout is not None:
            body = shard_map_compat(body, self._layout, (
                None, None, None, None if tab is None else "pages"))

        def fn(tok, pos, k):
            return body(tok, pos, k, tab)
        return self._dispatch("decode", width, fn, [tok, pos, k],
                              self._dead_decode)

    def _dead_decode(self) -> List[np.ndarray]:
        """Decode operands with every lane at pos = -1 (a no-op)."""
        n = self.n_slots
        return [np.zeros((n,), np.int32), np.full((n,), -1, np.int32),
                np.full((n,), self._k_fill, np.int32)]

    def _chunk_call(self, toks, slot, start, tlen, k, width: Optional[int],
                    prefix: Optional[int]):
        """Batched chunk dispatch -> (logits [P, V], greedy ids [P]); the
        bucket is (lanes, chunk width, page width | slab read prefix).
        Under a mesh ``slot`` holds shard-local lanes laid out ``[dp,
        P_local]``."""
        tab = None if width is None else self._device_table(width)
        n_lanes, C = toks.shape

        def body(toks, slot, start, tlen, k, tab):
            kw: Dict[str, Any] = {}
            if self._k_threading:
                kw["k_active"] = k
            if tab is not None:
                kw["page_tab"] = tab
            else:
                kw["prefix_len"] = prefix
            logits, _ = self.api.prefill_chunk(
                self.params, self.cfg, {"tokens": toks}, self.state, slot,
                start, self.swan, self.projections, true_len=tlen, **kw)
            return logits, torch.argmax(logits, dim=-1)
        if self._layout is not None:
            body = shard_map_compat(body, self._layout, (
                None, "lanes", None, None, None,
                None if tab is None else "pages"))

        def fn(toks, slot, start, tlen, k):
            return body(toks, slot, start, tlen, k, tab)
        return self._dispatch("chunk", (n_lanes, C, width, prefix), fn,
                              [toks, slot, start, tlen, k],
                              lambda: self._dead_chunk(n_lanes, C))

    def _dead_chunk(self, n_lanes: int, C: int) -> List[np.ndarray]:
        """Chunk operands with every lane parked off its shard (slot =
        n_local; n_slots at dp = 1)."""
        return [np.zeros((n_lanes, C), np.int64),
                np.full((n_lanes,), self.n_local, np.int64),
                np.zeros((n_lanes,), np.int64), np.ones((n_lanes,), np.int64),
                np.full((n_lanes,), self._k_fill, np.int64)]

    def _transient_state(self, pad_len: int) -> Params:
        """The single-slot prefill state, cut to a pad bucket: the slab
        takes all max_seq rows (its insert needs them), the paged engine
        the bucket's whole pages.  Graphed, one max_seq state serves every
        bucket and lives with the engine (the graphs point into it);
        eager, each admission allocates its bucket's rows and the insert
        drops them."""
        s1 = self.max_seq
        if self.paged:
            ps = self.pool.page_size
            s1 = -(-pad_len // ps) * ps
        if self._transient is None:
            rows = self.max_seq if self._graphs is not None else s1
            self._transient = self.api.init_serve_state(
                self.cfg, self.swan, 1, rows, self.device)
        if not self.paged:
            return self._transient
        t = dict(self._transient)
        for side in ("k", "v"):
            t[side] = {n: x[:, :, :, :s1] for n, x in t[side].items()}
        return t

    def _prefill_call(self, toks, k, tlen):
        """Monolithic prefill of one prompt [1, pad] into the transient ->
        logits [1, V] at its last real token."""
        pad_len = toks.shape[1]
        state1 = self._transient_state(pad_len)

        def fn(toks, k, tlen):
            for x in _leaves(state1):       # a fresh state, as at init
                if x.dtype == torch.int32:
                    x.fill_(-1)
                else:
                    hc._bits(x).zero_()
            kw = {"k_active": k} if self._k_threading else {}
            if self._bucketing:
                kw["true_len"] = tlen
            logits, _ = self.api.prefill(
                self.params, self.cfg, {"tokens": toks}, state1, self.swan,
                self.projections, **kw)
            return logits[:, -1]
        return self._dispatch(
            "prefill", pad_len, fn, [toks, k, tlen],
            lambda: [np.zeros((1, pad_len), np.int64),
                     np.asarray(self._k_fill, np.int32),
                     np.asarray(1, np.int32)])

    def _insert_call(self, pad_len: int, slot, phys=None) -> None:
        """Insert the transient into lane ``slot`` (``n_slots`` parks it:
        ring and slab writes drop; paged, ``phys`` names the trash page).
        Paged under a mesh, ``phys`` holds the slot's shard-local pages:
        the insert lands on the owner's block of the pool."""
        state1 = self._transient_state(pad_len)
        if self.paged:
            ps = self.pool.page_size
            layout = self._layout

            def fn(slot, phys):
                if layout is not None:
                    phys = layout.slot_pages(slot, phys)
                pc.paged_insert_prefill_(self.state, state1, slot, phys, ps)
            n_pg = -(-pad_len // ps)
            self._dispatch("insert_paged", pad_len, fn, [slot, phys],
                           lambda: [np.asarray(self.n_slots, np.int64),
                                    np.full((n_pg,), pc.TRASH_PAGE,
                                            np.int64)])
        else:
            def fn(slot):
                _insert_slot_(self.state, state1, slot)
            self._dispatch("insert", pad_len, fn, [slot],
                           lambda: [np.asarray(self.n_slots, np.int64)])
        if self._graphs is None:
            self._transient = None      # eager: freed with the admission

    # ------------------------------------------------------------------
    # Token fetch
    # ------------------------------------------------------------------

    def _fetch_buffer(self, key, shape, dtype) -> torch.Tensor:
        """A host buffer of the token fetch (pinned when the engine runs
        on the card), allocated once per key."""
        buf = self._fetch_bufs.get(key)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype,
                              pin_memory=self.device.type == "cuda")
            self._fetch_bufs[key] = buf
        return buf

    def _sample(self, logits: torch.Tensor, req, n_prev: int) -> int:
        """Host-side sampling of one token from a [V] logits row: the first
        argmax for greedy requests; for temperature requests a draw from a
        generator seeded by (request seed, draw index)."""
        if req.temperature <= 0.0:
            return int(torch.argmax(logits.float()))
        seed = int(np.random.SeedSequence([req.seed, n_prev])
                   .generate_state(1)[0])
        gen = torch.Generator().manual_seed(seed)
        return int(sample_token(logits.float().cpu()[None], req.temperature,
                                gen)[0])

    def _start_fetch(self, src: str, logits: torch.Tensor,
                     greedy: torch.Tensor, picks, step: int,
                     lanes=None) -> _PendingTokens:
        """Start the device-to-host token copy without blocking: the greedy
        ids [N] and, only for temperature lanes, their logits rows,
        gathered on the device at a power-of-two width (extra rows repeat
        lane 0) into pinned buffers, then a CUDA event.  The copies are
        ordered on the stream before any later dispatch can overwrite the
        graph's outputs."""
        n = greedy.shape[0]
        temp = [lane for lane, req, _ in picks if req.temperature > 0.0]
        rows = None
        if temp:
            idx = np.zeros((_pow2(len(temp)),), np.int64)
            idx[:len(temp)] = temp
            gathered = logits.index_select(0, self._to_device(idx))
            rows = self._fetch_buffer((src, n, idx.shape[0]),
                                      tuple(gathered.shape), gathered.dtype)
            rows.copy_(gathered, non_blocking=True)
        ids = self._fetch_buffer((src, n), (n,), greedy.dtype)
        ids.copy_(greedy, non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return _PendingTokens(greedy=ids, rows=rows, temp=temp,
                              picks=list(picks), step=step, lanes=lanes,
                              event=event)

    def _resolve_tokens(self, pending: _PendingTokens) -> List[int]:
        """Wait for a fetch and sample one token per (lane, request, draw
        index): the engine's one decode-token host sync."""
        if pending.event is not None:
            pending.event.synchronize()
        greedy = pending.greedy.tolist()
        return [int(greedy[lane]) if req.temperature <= 0.0
                else self._sample(pending.rows[pending.temp.index(lane)],
                                  req, draw)
                for lane, req, draw in pending.picks]

    def _lane_tokens(self, src: str, logits, greedy, picks) -> List[int]:
        """Synchronous fetch: start the copy and resolve it at once (chunk
        first tokens, and decode without ``async_fetch``)."""
        return self._resolve_tokens(
            self._start_fetch(src, logits, greedy, picks, self.step_count))

    def _resolve_pending(self) -> None:
        """Resolve the previous step's decode fetch at the top of
        ``step()``, before any scheduling decision, with the dispatch
        step's stamp: completion accounting equals the synchronous
        path's."""
        pending, self._pending = self._pending, None
        if pending is None:
            return
        t0 = time.perf_counter()
        toks = self._resolve_tokens(pending)
        self.metrics.histogram(
            "serve_token_fetch_ms", DISPATCH_MS_BUCKETS,
            "host block on the decode token transfer",
            mode="async").observe((time.perf_counter() - t0) * 1e3)
        step_now = self.step_count
        self.step_count = pending.step
        try:
            self._apply_decode_tokens(pending.lanes, toks)
        finally:
            self.step_count = step_now

    def _apply_decode_tokens(self, lanes, toks) -> None:
        """One decode step's tokens into the scheduler: advance positions,
        extend transcripts, feed ``next_tok``, count and trace each token,
        retire finished slots."""
        gap_hist = self.metrics.histogram(
            "serve_inter_token_steps", GAP_BUCKETS,
            "engine steps between consecutive tokens of one request")
        tok_ctr = self.metrics.counter(
            "serve_tokens_generated_total",
            "sampled tokens (first tokens included)")
        for i, tok in zip(lanes, toks):
            s = self.slots[i]
            self.slot_pos[i] += 1
            s.generated.append(tok)
            self.next_tok[i] = tok
            gap_hist.observe(self.step_count - s.last_token_step)
            s.last_token_step = self.step_count
            tok_ctr.inc()
            if self.trace is not None:
                self.trace.emit("token", step=self.step_count,
                                uid=s.req.uid, slot=i,
                                index=len(s.generated) - 1, token=tok)
            self._maybe_retire(i)

    def _bucket_len(self, plen: int) -> int:
        """Smallest power-of-two bucket holding ``plen`` (capped at
        max_seq)."""
        if not self._bucketing:
            return plen
        return min(_pow2(plen), self.max_seq)

    def _sparse_tokens(self, pos: int) -> int:
        """Winnowed (sparse-resident) tokens at decode position ``pos``."""
        return max(pos + 1 - self.swan.buffer, 0)

    def shard_of(self, slot: int) -> int:
        """The mesh shard that owns ``slot`` (0 on a single device)."""
        return slot // self.n_local

    def _page_bucket(self, slots) -> int:
        """Power-of-two bucket of logical pages covering every mapping in
        ``slots``: the shipped page-table prefix width."""
        p_used = max([1] + [int(self.pool.n_mapped[i]) for i in slots])
        return min(_pow2(p_used), self.pool.pages_per_seq)

    def _decode_bucket(self) -> int:
        dec = [i for i, s in enumerate(self.slots)
               if s is not None and s.state == "decoding"]
        return self._page_bucket(dec)

    def page_table_shipped_bytes(self) -> int:
        """Bytes of the page-table prefix a decode step ships right now
        ([n_slots, bucket] int32, the bucket over DECODING slots)."""
        return self.n_slots * self._decode_bucket() * 4

    def _record_first_token(self, slot: int, tok: int) -> None:
        """A slot's first sampled token: its transcript, and TTFT in steps
        from the request's arrival."""
        s = self.slots[slot]
        s.generated.append(tok)
        s.first_token_step = s.last_token_step = self.step_count
        self.next_tok[slot] = tok
        ttft = self.step_count - s.req.arrival_step
        self.metrics.histogram(
            "serve_ttft_steps", TTFT_BUCKETS,
            "engine steps from request arrival to first token").observe(ttft)
        self.metrics.counter("serve_tokens_generated_total",
                             "sampled tokens (first tokens included)").inc()
        if self.trace is not None:
            self.trace.emit("prefill_complete", step=self.step_count,
                            uid=s.req.uid, slot=slot,
                            prompt_len=len(s.req.tokens))
            self.trace.emit("first_token", step=self.step_count,
                            uid=s.req.uid, slot=slot, token=tok,
                            ttft_steps=ttft)
            self.trace.emit("token", step=self.step_count, uid=s.req.uid,
                            slot=slot, index=0, token=tok)

    def _admit(self, req: Request, slot: int) -> None:
        k_req = self.swan.k_max if (self.swan and req.k is None) else (req.k or 0)
        mode = "chunked" if self.prefill_chunk is not None else "monolithic"
        self.metrics.counter("serve_admissions_total",
                             "requests admitted into a slot",
                             mode=mode).inc()
        if self.trace is not None:
            self.trace.emit("admit", step=self.step_count, uid=req.uid,
                            slot=slot, shard=self.shard_of(slot),
                            prompt_len=len(req.tokens), k=req.k, mode=mode)
        if self.prefill_chunk is not None:
            # chunked admission claims the slot; chunks land as the
            # round-robin reaches it.  Paged: the prompt's whole winnow need
            # is HELD now, so a decoding slot's growth cannot starve it
            if self.paged:
                self.pool.reserve(slot, self.pool.pages_for(
                    self._sparse_tokens(len(req.tokens) - 1)))
            self.slots[slot] = _Slot(req=req, admitted_step=self.step_count,
                                     state="prefilling")
            self.slot_pos[slot] = -1        # dead lane until prefill done
            self.slot_k[slot] = k_req
            return
        plen = len(req.tokens)
        pad_len = self._bucket_len(plen)
        if self.paged:
            # pages first: a pool growth re-warms a warmed engine, which
            # reuses the transient that the prefill fills
            self._ensure_pages(slot, self._sparse_tokens(plen - 1))
        toks = np.zeros((1, pad_len), np.int64)
        toks[0, :plen] = np.asarray(req.tokens, np.int64)
        logits = self._prefill_call(toks, np.asarray(k_req, np.int32),
                                    np.asarray(plen, np.int32))
        self.dispatches["prefill"] += 1
        self.metrics.counter("serve_dispatches_total", "dispatches by kind",
                             kind="prefill").inc()
        self.metrics.counter("serve_prefill_tokens_total",
                             "prompt tokens prefilled").inc(plen)
        # sampled before the insert dispatch, which may reuse the graph
        # pool memory that holds these logits
        first = self._sample(logits[0], req, 0)
        slot_v = np.asarray(slot, np.int64)
        if self.paged:
            ps = self.pool.page_size
            self._insert_call(pad_len, slot_v,
                              self.pool.table[slot, :-(-pad_len // ps)])
        else:
            self._insert_call(pad_len, slot_v)
        self.slots[slot] = _Slot(req=req, admitted_step=self.step_count)
        self.slot_pos[slot] = plen
        self.slot_k[slot] = k_req
        self._record_first_token(slot, first)
        self._maybe_retire(slot)

    def _maybe_retire(self, slot: int) -> None:
        s = self.slots[slot]
        done = (len(s.generated) >= s.req.max_new_tokens
                or (s.req.eos is not None and s.generated[-1] == s.req.eos)
                or self.slot_pos[slot] >= self.max_seq)
        if not done:
            return
        reason = ("eos" if s.req.eos is not None
                  and s.generated[-1] == s.req.eos
                  else "max_tokens" if len(s.generated) >= s.req.max_new_tokens
                  else "max_seq")
        self.metrics.counter("serve_completions_total",
                             "retired requests by reason",
                             reason=reason).inc()
        self.metrics.histogram(
            "serve_request_steps", REQ_STEP_BUCKETS,
            "engine steps from admission to retirement").observe(
                self.step_count - s.admitted_step)
        if self.trace is not None:
            self.trace.emit("retire", step=self.step_count, uid=s.req.uid,
                            slot=slot, shard=self.shard_of(slot),
                            n_tokens=len(s.generated),
                            reason=reason, admitted_step=s.admitted_step,
                            first_token_step=s.first_token_step)
        self.completions.append(Completion(
            uid=s.req.uid, tokens=list(s.generated),
            prompt_len=len(s.req.tokens), k=s.req.k,
            admitted_step=s.admitted_step, finished_step=self.step_count,
            first_token_step=s.first_token_step))
        self.slots[slot] = None
        self.slot_pos[slot] = -1
        self.slot_k[slot] = self._k_fill
        self.next_tok[slot] = 0
        if self.paged:
            # pages return to the owning shard's free list NOW: a request
            # backfilled into this slot on the same step reuses them
            self.pool.free_slot(slot)

    def _next_request(self) -> Optional[Request]:
        """FIFO takes the oldest arrived request; ``srf`` the smallest total
        work (prompt + generation budget), FIFO-tiebroken."""
        avail = [r for r in self.queue if r.arrival_step <= self.step_count]
        if not avail:
            return None
        if self.admission == "srf":
            return min(avail, key=lambda r: len(r.tokens) + r.max_new_tokens)
        return avail[0]

    def _admit_pending(self) -> None:
        while self.n_active < self.n_slots:
            nxt = self._next_request()
            if nxt is None:
                return
            free = [i for i, s in enumerate(self.slots) if s is None]
            slot = free[0]
            if self.paged:
                # a request whose LIFETIME need exceeds a whole pool shard
                # can never run: grow (pool_grow) or fail fast
                lifetime = self.pool.pages_for(self._sparse_tokens(
                    len(nxt.tokens) + nxt.max_new_tokens - 1))
                if lifetime > self.pool.pages_per_shard - 1:
                    if not self.pool_grow:
                        raise PagePoolExhausted(
                            f"request {nxt.uid} needs {lifetime} pages over "
                            "its lifetime; each pool shard holds "
                            f"{self.pool.pages_per_shard - 1}")
                    self._grow_pool(lifetime + 1)
                # over-committed pool: admit only into a shard with enough
                # free pages for the prompt; otherwise grow, or hold until
                # pages free
                need = self.pool.pages_for(
                    self._sparse_tokens(len(nxt.tokens) - 1))
                fits = [i for i in free if need <=
                        self.pool.shard_free_pages(self.shard_of(i))]
                if not fits and self.pool_grow:
                    self._grow_pool(self.pool.pages_per_shard + max(need, 1))
                    fits = [i for i in free if need <=
                            self.pool.shard_free_pages(self.shard_of(i))]
                if not fits:
                    # held admission: counted per engine step spent waiting
                    self.metrics.counter(
                        "serve_admission_holds_total",
                        "steps an arrived request waited on pool pages").inc()
                    if self.trace is not None:
                        self.trace.emit("admission_hold",
                                        step=self.step_count, uid=nxt.uid,
                                        need_pages=need)
                    return
                slot = fits[0]
            self.queue.remove(nxt)
            self._admit(nxt, slot)

    # ------------------------------------------------------------------
    # Paged-pool elasticity
    # ------------------------------------------------------------------

    def _ensure_pages(self, slot: int, n_tokens: int) -> None:
        """``pool.ensure``, growing the pool first when ``pool_grow`` and
        the pool is over-committed; otherwise ``PagePoolExhausted``."""
        if not self.pool_grow:
            self.pool.ensure(slot, n_tokens)
            return
        try:
            self.pool.ensure(slot, n_tokens)
        except PagePoolExhausted:
            self._grow_pool(self.pool.pages_per_shard
                            + self.pool.pages_for(n_tokens))
            self.pool.ensure(slot, n_tokens)

    def _grow_pool(self, min_pages_per_shard: int) -> None:
        """Grow the device pool to at least ``min_pages_per_shard``
        (typically 2x) pages PER SHARD, copying the old pages: new pages
        append at the end of each shard's block, so local indices, and the
        page table, stay valid.  Capped at the full reservation, where
        every admission fits."""
        cap = self.n_local * self.pool.pages_per_seq + 1
        new = min(max(2 * self.pool.pages_per_shard, min_pages_per_shard),
                  cap)
        if new <= self.pool.pages_per_shard:
            raise PagePoolExhausted(
                f"page pool already at full reservation "
                f"({self.pool.pages_per_shard} pages/shard) — cannot grow")
        extra = new - self.pool.pages_per_shard
        dp = self.dp
        for side in self.state["pool"].values():
            for name, x in side.items():
                b = hc._bits(x)
                b = b.reshape(b.shape[0], dp, -1, *b.shape[2:])
                pad = torch.zeros((b.shape[0], dp, extra, *b.shape[3:]),
                                  dtype=b.dtype, device=b.device)
                side[name] = torch.cat([b, pad], dim=2).reshape(
                    x.shape[0], dp * new, *x.shape[2:]).view(x.dtype)
        old = self.pool.pages_per_shard
        self.pool.grow(new)
        if self._layout is not None:
            self._layout.pages_per_shard = new
            self._layout.check_specs(self.state, self._state_specs)
        self.metrics.counter("page_pool_grows_total",
                             "device pool growth events").inc()
        if self.trace is not None:
            self.trace.emit("pool_grow", step=self.step_count,
                            pages_per_shard_old=old, pages_per_shard_new=new)
        if self._graphs is not None:
            # the graphs point into the old pool: capture them anew, all
            # at once on a warmed engine (as the reference re-warms)
            self._graphs.drop()
            if self._warmed:
                self.warmup(self._warm_prompt_len)

    # ------------------------------------------------------------------
    # Engine step
    # ------------------------------------------------------------------

    def _device_table(self, width: int) -> torch.Tensor:
        """The static device buffer of the page table's first ``width``
        columns, refreshed in place (an asynchronous host-to-device copy,
        ordered before the dispatch that reads it) only when the host
        table changed."""
        buf = self._tables.get(width)
        if buf is None:
            buf = torch.zeros((self.n_slots, width), dtype=torch.int32,
                              device=self.device)
            self._tables[width] = buf
            self._table_ver[width] = -1
        if self._table_ver[width] != self.pool.version:
            buf.copy_(torch.from_numpy(
                np.ascontiguousarray(self.pool.table[:, :width])),
                non_blocking=True)
            self._table_ver[width] = self.pool.version
        return buf

    def _select_prefills(self, shard: int) -> List[int]:
        """Round-robin up to ``prefill_slots`` PREFILLING slots of
        ``shard`` within its per-step token budget, from the shard's own
        pointer; each selected slot advances one FULL chunk, so chunk
        boundaries (and tokens) never depend on the schedule."""
        lo = shard * self.n_local
        cands = [i for i in range(lo, lo + self.n_local)
                 if self.slots[i] is not None
                 and self.slots[i].state == "prefilling"]
        if not cands:
            return []
        rr = self._prefill_rr[shard]
        order = sorted(cands, key=lambda j: (j - rr) % self.n_slots)
        sel: List[int] = []
        spent = 0
        for i in order:
            if len(sel) >= self.prefill_slots or spent >= self.prefill_budget:
                break
            s = self.slots[i]
            sel.append(i)
            spent += min(len(s.req.tokens) - s.n_prefilled, self.prefill_chunk)
        self._prefill_rr[shard] = (sel[-1] + 1) % self.n_slots
        return sel

    def _advance_prefills(self) -> None:
        """Advance every shard's selected in-flight prefills by one chunk
        EACH in ONE batched chunk dispatch.  The lane axis is laid out
        ``[dp, P_local]``: shard ``s``'s block holds only its own slots,
        as shard-local lanes.  The per-shard lane count is a power of two
        (dead lanes park at slot = n_local, off the shard); full chunks
        share one width."""
        sels = [self._select_prefills(s) for s in range(self.dp)]
        widest = max(len(s) for s in sels)
        if widest == 0:
            return
        Pl = _pow2(widest)
        n_lanes = self.dp * Pl
        lens, pads = {}, []
        for sel in sels:
            for i in sel:
                s = self.slots[i]
                rem = len(s.req.tokens) - s.n_prefilled
                lens[i] = min(rem, self.prefill_chunk)
                pads.append(self.prefill_chunk if rem >= self.prefill_chunk
                            else _pow2(lens[i]))
        C = max(pads)
        toks = np.zeros((n_lanes, C), np.int64)
        slot_v = np.full((n_lanes,), self.n_local, np.int64)  # parked
        start_v = np.zeros((n_lanes,), np.int64)
        tlen_v = np.ones((n_lanes,), np.int64)
        k_v = np.full((n_lanes,), self._k_fill, np.int64)
        picks = []                                  # (lane, global slot)
        for sh, sel in enumerate(sels):
            for j, i in enumerate(sel):
                lane = sh * Pl + j
                s = self.slots[i]
                st0, t = s.n_prefilled, lens[i]
                toks[lane, :t] = np.asarray(s.req.tokens[st0:st0 + t],
                                            np.int64)
                slot_v[lane] = i - sh * self.n_local
                start_v[lane], tlen_v[lane] = st0, t
                k_v[lane] = self.slot_k[i]
                picks.append((lane, i))
        sel = [i for _, i in picks]
        width = prefix = None
        if self.paged:
            for lane, i in picks:
                # map pages for the tokens this chunk winnows; overshoot
                # past them lands on the trash page
                self._ensure_pages(i, self._sparse_tokens(
                    int(start_v[lane]) + lens[i] - 1))
            pg = _pow2(max(1, max(int(self.pool.n_mapped[i]) for i in sel)))
            width = min(pg, self.pool.pages_per_seq)
        else:
            prefix = min(_pow2(int(start_v.max()) + C), self.max_seq)
        logits, greedy = self._chunk_call(toks, slot_v, start_v, tlen_v, k_v,
                                          width, prefix)
        self.dispatches["chunk"] += 1
        n_tok = sum(lens.values())
        self.metrics.counter("serve_dispatches_total", "dispatches by kind",
                             kind="chunk").inc()
        self.metrics.counter("serve_prefill_tokens_total",
                             "prompt tokens prefilled").inc(n_tok)
        if self.trace is not None:
            self.trace.emit("chunk_dispatch", step=self.step_count,
                            lanes=len(sel), slots=sel, tokens=n_tok)
        fins = []
        for lane, i in picks:
            s = self.slots[i]
            s.n_prefilled += lens[i]
            if s.n_prefilled == len(s.req.tokens):      # prompt complete
                fins.append((lane, i))
        if not fins:
            return
        firsts = self._lane_tokens(
            "chunk", logits, greedy,
            [(lane, self.slots[i].req, 0) for lane, i in fins])
        for (_, i), first in zip(fins, firsts):
            self.slots[i].state = "decoding"
            self.slot_pos[i] = len(self.slots[i].req.tokens)
            self._record_first_token(i, first)
            self._maybe_retire(i)

    def step(self) -> int:
        """One scheduler iteration: resolve the previous step's token fetch
        (``async_fetch``) -> admit -> one batched chunk dispatch -> one
        batched decode dispatch -> retire (or leave the fetch in flight).
        Returns the number of sequences that finished during this call;
        with ``async_fetch`` a dispatch's completions surface one call
        later, with the same step stamps."""
        if self._profiler is not None:
            self._profiler.step_start(self.step_count)
        n_done0 = len(self.completions)
        self._resolve_pending()
        self._admit_pending()
        if self.prefill_chunk is not None:
            self._advance_prefills()
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and s.state == "decoding"]
        if active:
            width = None
            if self.paged:
                # map the page each sequence's decode is about to winnow
                # into, then ship a power-of-two prefix of the table
                for i in active:
                    self._ensure_pages(i, self._sparse_tokens(
                        int(self.slot_pos[i])))
                width = self._page_bucket(active)
            logits, greedy = self._decode_call(self.next_tok, self.slot_pos,
                                               self.slot_k, width)
            self.dispatches["decode"] += 1
            self.metrics.counter("serve_dispatches_total",
                                 "dispatches by kind", kind="decode").inc()
            if self.trace is not None:
                self.trace.emit("decode_dispatch", step=self.step_count,
                                lanes=len(active))
            picks = [(i, self.slots[i].req, len(self.slots[i].generated))
                     for i in active]
            if self.async_fetch:
                self._pending = self._start_fetch(
                    "decode", logits, greedy, picks, self.step_count,
                    lanes=active)
            else:
                t0 = time.perf_counter()
                toks = self._lane_tokens("decode", logits, greedy, picks)
                self.metrics.histogram(
                    "serve_token_fetch_ms", DISPATCH_MS_BUCKETS,
                    "host block on the decode token transfer",
                    mode="sync").observe((time.perf_counter() - t0) * 1e3)
                self._apply_decode_tokens(active, toks)
        self.step_count += 1
        self._sample_gauges()
        if self._profiler is not None:
            self._profiler.step_end(self.step_count)
        return len(self.completions) - n_done0

    def profile_steps(self, n_steps: int, logdir: str) -> None:
        """Profile the next ``n_steps`` engine steps (admission, chunk and
        decode dispatch included) with ``torch.profiler``, the card's
        activity too on a CUDA device; the trace lands in ``logdir``."""
        self._profiler = StepProfiler(logdir, n_steps, trace=self.trace,
                                      cuda=self.device.type == "cuda")

    def run(self, requests: Optional[Sequence[Request]] = None,
            max_steps: Optional[int] = None) -> List[Completion]:
        """Submit ``requests`` and step until everything drains (or
        ``max_steps``).  Returns completions in finish order."""
        for r in requests or ():
            self.submit(r)
        n0 = len(self.completions)
        steps = 0
        while not self.done and (max_steps is None or steps < max_steps):
            self.step()
            steps += 1
        return self.completions[n0:]

    # ------------------------------------------------------------------
    # Accounting
    # ------------------------------------------------------------------

    def _n_attn(self) -> int:
        """Attention layers: the layers that hold a KV cache."""
        return sum(1 for i in range(self.cfg.n_layers)
                   if self.cfg.layer_kind(i) == "attn")

    def _slab_reserved(self, n: int) -> int:
        """The analytic slab bytes of ``n`` slots (linear in ``n``)."""
        L = self._n_attn()
        if self.swan is None:
            return L * hc.dense_cache_bytes(self.cfg, n, self.max_seq)
        return L * (hc.cache_bytes(self.cfg, self.swan, n, self.max_seq)
                    + n * self.swan.buffer * 4)

    def _slab_check(self) -> int:
        """The slab's reserved bytes (the analytic layout), checked against
        the bytes of the resident state: the slab commits the worst case
        at init, so they must be equal.  A recurrent family's state has no
        such layout: its bytes are the analytic Eq. 1 report's."""
        if self.api.init_paged_state is None:
            return serve_cache_report(self.cfg, self.swan, self.n_slots,
                                      self.max_seq)["bytes"]
        reserved = self._slab_reserved(self.n_slots)
        live = sum(x.numel() * x.element_size() for x in _leaves(self.state))
        if reserved != live:
            raise RuntimeError(f"slab reserved {reserved} != resident {live}")
        return reserved

    def _cache_bytes(self) -> Dict[str, Any]:
        """The one source of cache byte accounting, read by
        ``cache_report()`` and the per-step ``kv_cache_*`` gauges:
        ``reserved_bytes`` / ``live_bytes`` (+ ``page_table_shipped_bytes``
        paged), with a ``shards`` breakdown, one entry per mesh shard,
        whose entries sum exactly to the totals (None for a recurrent
        family, whose bytes are the analytic Eq. 1 report's).  Host
        arithmetic only."""
        if self.api.init_paged_state is None:
            b = self._slab_bytes
            return {"reserved_bytes": b, "live_bytes": b, "shards": None}
        if not self.paged:
            # the slab layout is linear in the batch axis, so each shard
            # carries exactly its slots' share
            reserved = self._slab_bytes
            sh = self._slab_reserved(self.n_local)
            return {"reserved_bytes": reserved, "live_bytes": reserved,
                    "shards": [{"reserved_bytes": sh, "live_bytes": sh}
                               for _ in range(self.dp)]}
        page_b = pc.page_bytes(self.cfg, self.swan, self.pool.page_size)
        bucket = self._decode_bucket()
        overhead = (pc.ring_bytes(self.cfg, self.swan, self.n_slots)
                    + self.n_slots * bucket * 4)
        # per shard: its block of the pool, its slots' rings and its rows
        # of the shipped table prefix (rings and table are linear in the
        # batch axis, page blocks equal), so the entries sum to the totals
        sh_over = (pc.ring_bytes(self.cfg, self.swan, self.n_local)
                   + self.n_local * bucket * 4)
        return {
            "reserved_bytes": self.pool.reserved_bytes(page_b) + overhead,
            "live_bytes": self.pool.live_bytes(page_b) + overhead,
            "page_table_shipped_bytes": self.n_slots * bucket * 4,
            "shards": [
                {"reserved_bytes":
                 self.pool.shard_reserved_bytes(s, page_b) + sh_over,
                 "live_bytes": self.pool.shard_live_bytes(s, page_b) + sh_over,
                 "page_table_shipped_bytes": self.n_local * bucket * 4,
                 "live_pages": self.pool.shard_live_pages(s)}
                for s in range(self.dp)]}

    def cache_report(self) -> Dict[str, Any]:
        """Cache accounting across all slots in the config's dtypes:
        ``reserved_bytes`` (allocated) and ``live_bytes`` (addressable by
        live tokens), equal on the slab; paged adds the pool's page counts
        and the shipped table prefix."""
        rep = serve_cache_report(self.cfg, self.swan, self.n_slots,
                                 self.max_seq)
        if self.api.init_paged_state is None:
            # recurrent families: the analytic Eq. 1 report, no shards
            rep["reserved_bytes"] = rep["live_bytes"] = rep["bytes"]
            return rep
        if not self.paged:
            self._slab_check()
        acct = self._cache_bytes()
        rep["reserved_bytes"] = acct["reserved_bytes"]
        rep["live_bytes"] = acct["live_bytes"]
        rep["shards"] = acct["shards"]
        dense_phys = self._n_attn() * hc.dense_cache_bytes(
            self.cfg, self.n_slots, self.max_seq)
        if not self.paged:
            rep["bytes"] = acct["reserved_bytes"]
            if self.swan is not None:
                rep["dense_bytes"] = dense_phys
                rep["saving"] = 1.0 - rep["bytes"] / dense_phys
            return rep
        rep["mode"] += "+paged"
        rep["slab_bytes"] = self._n_attn() * hc.cache_bytes(
            self.cfg, self.swan, self.n_slots, self.max_seq)
        rep["bytes"] = acct["live_bytes"]
        rep["dense_bytes"] = dense_phys
        rep["saving"] = 1.0 - acct["live_bytes"] / dense_phys
        rep.update(page_size=self.pool.page_size, n_pages=self.pool.n_pages,
                   live_pages=self.pool.live_pages)
        rep["page_table_shipped_bytes"] = acct["page_table_shipped_bytes"]
        return rep

    def _sample_gauges(self) -> None:
        """End-of-step gauges, the reference's, the ``shard_*`` ones
        labelled ``shard=s`` for each mesh shard.  Skipped under the null
        registry, so ``metrics=False`` pays nothing per step."""
        m = self.metrics
        if not m.enabled:
            return
        m.gauge("serve_engine_steps",
                "scheduler steps taken").set(self.step_count)
        m.gauge("serve_queue_depth",
                "arrived requests waiting for a slot").set(self.pending)
        m.gauge("serve_lanes_active",
                "slots holding a live request").set(self.n_active)
        acct = self._cache_bytes()
        m.gauge("kv_cache_reserved_bytes",
                "cache bytes physically allocated").set(
                    acct["reserved_bytes"])
        m.gauge("kv_cache_live_bytes",
                "cache bytes addressable by live tokens").set(
                    acct["live_bytes"])
        if self.paged:
            m.gauge("page_table_shipped_bytes",
                    "bytes of the shipped [n_slots, bucket] int32 "
                    "page-table prefix").set(
                        acct["page_table_shipped_bytes"])
            m.gauge("page_pool_live_pages",
                    "pages mapped to live sequences").set(
                        self.pool.live_pages)
            m.gauge("page_pool_free_pages",
                    "pages on the free lists").set(self.pool.free_pages)
        for sh in range(self.dp):
            lo = sh * self.n_local
            lanes = self.slots[lo:lo + self.n_local]
            m.gauge("shard_lanes_active",
                    "decoding lanes on this shard", shard=sh).set(
                        sum(1 for s in lanes
                            if s is not None and s.state == "decoding"))
            m.gauge("shard_lanes_prefilling",
                    "prefilling lanes on this shard", shard=sh).set(
                        sum(1 for s in lanes
                            if s is not None and s.state == "prefilling"))
            if acct["shards"] is not None:
                e = acct["shards"][sh]
                m.gauge("shard_kv_cache_reserved_bytes",
                        "cache bytes physically allocated on this shard",
                        shard=sh).set(e["reserved_bytes"])
                m.gauge("shard_kv_cache_live_bytes",
                        "live cache bytes on this shard", shard=sh).set(
                            e["live_bytes"])
            if self.paged:
                m.gauge("shard_page_pool_live_pages",
                        "live pages on this shard", shard=sh).set(
                            self.pool.shard_live_pages(sh))
                m.gauge("shard_page_pool_free_pages",
                        "free pages on this shard", shard=sh).set(
                            self.pool.shard_free_pages(sh))


def _tree_map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _tree_map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _insert_slot_(big: Params, one: Params, slot) -> None:
    """Copy a batch=1 prefilled slab state [L, 1, ...] into lane ``slot``
    of the batched state [L, n_slots, ...], in place; ``slot = n_slots``
    (parked) writes nothing."""
    for name, b in big.items():
        if isinstance(b, dict):
            _insert_slot_(b, one[name], slot)
        else:
            hc.write_lanes_(b.movedim(1, 0), one[name].movedim(1, 0),
                            torch.as_tensor(slot, device=b.device).reshape(1))
