"""swanlint Layer 2: the serve auditor (port of
``repro/analysis/lint/audit.py``).

Layer 1 reads source; this layer reads what the engine actually runs.  The
reference lowers the engine's executables and parses their HLO; the port
holds one CUDA graph per shape bucket (``runtime.graphs``) and eager
dispatch bodies, so it reads those:

  (i)   graph-count bounds (``_exec_count_checks``) — power-of-two
        bucketing keeps the graph family at O(log max_seq): one decode
        graph per page bucket (one on the slab), one chunk graph per
        (lanes, chunk, prefix | page) bucket, and an identical workload
        re-run captures nothing (``ServeEngine.executable_census()``);
  (i')  the warmup contract (``warmup_checks``) — after ``warmup()`` the
        census covers the enumerated family, a second ``warmup()``
        captures nothing, and a randomized mixed workload captures nothing
        (``repro_torch.obs.compile_events``);
  (ii)  no host crossing inside a dispatch — ``transfer_check`` over a
        dispatch body's :class:`~repro_torch.analysis.cost.StepCosts` (no
        ``.item()``, no device-to-host copy) or over a captured graph's
        :class:`GraphCensus` (no device-to-host memcpy node, no host node);
        and per engine step only the designed token fetch blocks the host
        (``step_sync_checks``);
  (iii) an empty collective inventory (``collective_check``: no c10d op
        in a body, no NCCL kernel in a graph) — the serve path is
        lane-local;
  (iv)  kernel prechecks (``kernel_precheck_checks``) — each kernel's
        launch validation at the engine's shapes, and each captured decode
        and chunk graph holding one launch of its layout's kernels per
        attention layer (``audit_graphs``).

A graph's node census comes from its CUDA graph as CUDA describes it
(``cuGraphDebugDotPrint`` on the graph ``GraphSet`` keeps when its
``keep_census`` is set, parsed by :func:`parse_graph_dot`): every node's
type, each kernel node's symbol and each memcpy node's direction, exactly,
host nodes included.  A profile of one replay (CUPTI) sees only what ran,
shows no host node as such and can lose records, so it is not used here.

Each assertion is an :class:`AuditCheck` with status pass/fail/skip.  On
the CPU there are no graphs and no kernels: those checks report "skip"
with that reason; the dispatch-body and per-step checks run there through
the cost analyzer.
"""
from __future__ import annotations

import contextlib
import math
import re
import warnings
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

from repro_torch.analysis.cost import GATHERS, CostMode, StepCosts
from repro_torch.kernels.dispatch import plain_reads

__all__ = ["AuditCheck", "GraphCensus", "parse_graph_dot", "transfer_check",
           "collective_check", "count_check", "capture_check",
           "launch_check", "logical_view_check", "kernel_precheck_checks",
           "dispatch_checks", "audit_graphs", "warmup_checks",
           "step_sync_checks", "run_audit", "decode_groups"]

# the kernels' CUDA symbols (mangled names contain them), per dispatch
DECODE_SYMBOLS = ("swan_decode_kernel", "swan_decode_merge_kernel")
CHUNK_SYMBOLS = ("swan_chunk_mma_kernel", "swan_chunk_f32_kernel")
# each layout's kernels (their ``CudaKernel.name``) per dispatch family
LAYOUT_KERNELS = {
    "slab": {"decode": "swan_decode", "chunk": "swan_chunk_stats"},
    "paged": {"decode": "swan_decode_paged",
              "chunk": "swan_chunk_stats_paged"},
}
# the engine's designed host fetch points (Layer 1's allowlist)
FETCH_POINTS = ("_resolve_tokens", "_sample")


def decode_groups(cfg) -> int:
    """The decode kernels' (B1/B2) launches per attention layer per decode
    dispatch: the groups of ``swan_decode.g_plan`` for the config's query
    group (1 up to G = 8; 2 at llama3-405b's G = 16).  The chunk kernels
    launch once per layer whatever G is."""
    from repro_torch.kernels.swan_decode.swan_decode import g_plan
    return g_plan(cfg.n_heads // cfg.n_kv_heads)[1]


@dataclass
class AuditCheck:
    check: str                  # e.g. "host-transfers/slab/decode"
    status: str                 # "pass" | "fail" | "skip"
    detail: str = ""

    def to_json(self) -> Dict[str, str]:
        return {"check": self.check, "status": self.status,
                "detail": self.detail}


# ---------------------------------------------------------------------------
# Graph census
# ---------------------------------------------------------------------------

@dataclass
class GraphCensus:
    """The nodes of one captured CUDA graph: kernel nodes by symbol,
    memcpy nodes by direction ("HtoD", "DtoH", "DtoD", ...), host nodes,
    and every other node by its type."""
    kernels: Counter = field(default_factory=Counter)
    memcpy: Counter = field(default_factory=Counter)
    host: int = 0
    other: Counter = field(default_factory=Counter)

    def count(self, symbol: str) -> int:
        """Kernel nodes whose (mangled) symbol contains ``symbol``."""
        return sum(n for name, n in self.kernels.items() if symbol in name)

    @property
    def nccl(self) -> int:
        return sum(n for name, n in self.kernels.items()
                   if "nccl" in name.lower())


_LABEL_RE = re.compile(r'"graph_\d+_node_\d+"\[[^\]]*?label="(.*?)"\];',
                       re.DOTALL)
_TYPE_RE = re.compile(r"^[A-Z][A-Z_]*$")
_DIR_RE = re.compile(r"^\((\w+),")


def parse_graph_dot(text: str) -> GraphCensus:
    """Census of a ``cuGraphDebugDotPrint`` description in its terse form
    (flags 0, as :meth:`GraphSet.dot` prints it): a node's label is its id,
    then a kernel's symbol or the node's type (``MEMCPY`` followed by
    ``(DtoH,bytes)``, ``HOST``, ...)."""
    census = GraphCensus()
    for label in _LABEL_RE.findall(text):
        rows = [r.strip() for r in label.splitlines()
                if r.strip() and not r.split()[0].isdigit()]
        head = rows[0] if rows else "?"
        if head == "MEMCPY":
            m = _DIR_RE.match(rows[1]) if len(rows) > 1 else None
            census.memcpy[m.group(1) if m else "?"] += 1
        elif head == "HOST":
            census.host += 1
        elif _TYPE_RE.match(head):
            census.other[head] += 1
        else:
            census.kernels[head] += 1
    return census


# ---------------------------------------------------------------------------
# Pure check helpers (unit-testable without building an engine)
# ---------------------------------------------------------------------------

def transfer_check(subject, label: str) -> AuditCheck:
    """(ii): a dispatch body (``StepCosts``) or a captured graph
    (``GraphCensus``) must not cross to the host."""
    name = f"host-transfers/{label}"
    if isinstance(subject, GraphCensus):
        problems = []
        if subject.memcpy.get("DtoH"):
            problems.append(f"{subject.memcpy['DtoH']} device-to-host "
                            "memcpy node(s)")
        if subject.host:
            problems.append(f"{subject.host} host node(s)")
        if problems:
            return AuditCheck(name, "fail", "; ".join(problems))
        return AuditCheck(name, "pass", "no device-to-host copy and no host "
                          f"node (memcpy {dict(subject.memcpy)})")
    if subject.host_transfers:
        ops = [o.name for o in subject.ops if o.kind == "transfer"]
        return AuditCheck(name, "fail", f"{subject.host_transfers} host "
                          f"transfer(s): {ops[:5]}")
    return AuditCheck(name, "pass", "no host boundary crossings")


def collective_check(subject, label: str, allowed: tuple = ()) -> AuditCheck:
    """(iii): the collective inventory against the declared contract
    (empty for the lane-local serve path)."""
    name = f"collectives/{label}"
    if isinstance(subject, GraphCensus):
        extra = {"nccl": subject.nccl} if subject.nccl and \
            "nccl" not in allowed else {}
    else:
        extra = {k: v for k, v in subject.per_collective.items()
                 if k not in allowed}
    if extra:
        return AuditCheck(name, "fail",
                          f"undeclared collectives on the serve path: {extra}")
    return AuditCheck(name, "pass",
                      f"inventory matches contract (allowed={list(allowed)})")


def count_check(label: str, observed: int, bound: int,
                what: str = "graphs") -> AuditCheck:
    """(i): an observed graph count within its O(log) bound (``observed``
    < 0: not exposed)."""
    if observed < 0:
        return AuditCheck(f"exec-count/{label}", "skip",
                          f"no {what} census on this engine")
    if observed > bound:
        return AuditCheck(f"exec-count/{label}", "fail",
                          f"{observed} {what} > bound {bound}")
    return AuditCheck(f"exec-count/{label}", "pass",
                      f"{observed} {what} <= bound {bound}")


def capture_check(label: str, lazy_before: int, lazy_after: int
                  ) -> AuditCheck:
    """No graph captured mid-serve between two readings of
    ``GraphSet.lazy_captures``."""
    n = lazy_after - lazy_before
    if n:
        return AuditCheck(f"captures/{label}", "fail",
                          f"captured {n} graph(s) mid-serve after warmup")
    return AuditCheck(f"captures/{label}", "pass",
                      "no graph captured mid-serve")


def launch_check(label: str, launches: Dict[str, int],
                 dispatches: Dict[str, int], layout: str,
                 n_layers: int, groups: int = 1) -> AuditCheck:
    """Each layout's chunk kernel launched ``n_layers`` times per chunk
    dispatch and its decode kernel ``groups x n_layers`` times per decode
    dispatch (``decode_groups``; counted through graph replays), the other
    layout's and the bench-only kernels never."""
    want = LAYOUT_KERNELS[layout]
    ok = (launches[want["decode"]] == groups * n_layers * dispatches["decode"]
          and launches[want["chunk"]] == n_layers * dispatches["chunk"]
          and dispatches["decode"] > 0 and dispatches["chunk"] > 0)
    others = {n: c for n, c in launches.items()
              if n not in want.values() and c}
    per = (f"{n_layers}" if groups == 1
           else f"{groups} x {n_layers} decode, {n_layers} chunk")
    if not ok:
        return AuditCheck(f"launches/{label}", "fail",
                          f"launches {launches} != {per} x dispatches "
                          f"{dispatches}")
    if others:
        return AuditCheck(f"launches/{label}", "fail",
                          f"another layout's kernel ran: {others}")
    return AuditCheck(f"launches/{label}", "pass",
                      f"{per} launches per dispatch {dispatches}")


def logical_view_check(costs: StepCosts, label: str, view_elems: int,
                       expect_materialized: bool = False) -> AuditCheck:
    """The paged decode step must gather no ``paged_logical_view``: no
    gather op (``analysis.cost.GATHERS``) with a result of ``view_elems``
    or more elements (= lanes x Kv x bucket·page_size x k_max, the view's
    values leaf).  ``expect_materialized=True`` inverts it for the plain
    path, proving the detector sees the gather it rules out."""
    big = [(o.name, o.out_elems) for o in costs.ops
           if o.name in GATHERS and o.out_elems >= view_elems]
    name = f"logical-view/{label}"
    if expect_materialized:
        if big:
            return AuditCheck(name, "pass", "plain path materialises the "
                              f"view as expected: {big[0][0]} of "
                              f"{big[0][1]} elements")
        return AuditCheck(name, "fail", f"detector found no gather >= "
                          f"{view_elems} elements on the plain path — "
                          "threshold or gather idiom drifted")
    if big:
        return AuditCheck(name, "fail", f"{len(big)} materialised "
                          f"logical-view gather(s) >= {view_elems} "
                          f"elements: {big[:3]}")
    return AuditCheck(name, "pass", f"no gather >= {view_elems} elements — "
                      "pool pages stream through the kernel")


def kernel_precheck_checks(cfg, swan, max_seq: int,
                           page_size: Optional[int] = None,
                           chunk_q: Optional[int] = None) -> List[AuditCheck]:
    """(iv): each kernel's static launch validation at the engine's shapes:
    B1 over the slab's ``max_seq`` rows and (``page_size``) B2 over the
    per-sequence page reservation; (``chunk_q``) B3/B4 at that query-row
    count; B5 at ``max_seq`` queries and keys."""
    import torch

    from repro_torch.kernels.flash_prefill import flash_prefill as fp
    from repro_torch.kernels.swan_chunk import swan_chunk as sc
    from repro_torch.kernels.swan_decode import swan_decode as sd

    def fold(name: str, r: dict) -> AuditCheck:
        status = "fail" if r["errors"] else "pass"
        detail = "; ".join(r["errors"]) or f"shared memory {r['smem_bytes']} B"
        return AuditCheck(f"kernel-precheck/{name}", status, detail)

    dtype = getattr(torch, cfg.dtype)
    out: List[AuditCheck] = []
    if swan is not None:
        v_dtype = (dtype if not swan.quantize else torch.int8
                   if swan.quant_dtype == "int8" else torch.float8_e4m3fn)
        G = cfg.n_heads // cfg.n_kv_heads
        extents = [("swan_decode", max(max_seq, 1))]
        if page_size is not None:
            extents.append(("swan_decode_paged",
                            max(max_seq // page_size, 1) * page_size))
        for name, S in extents:
            out.append(fold(name, sd.precheck(G=G, dh=cfg.d_head,
                                              k_max=swan.k_max,
                                              b=swan.buffer, v_dtype=v_dtype,
                                              S=S)))
            if chunk_q is not None:
                cname = name.replace("swan_decode", "swan_chunk_stats")
                out.append(fold(cname, sc.precheck(dh=cfg.d_head,
                                                   k_max=swan.k_max, S=S,
                                                   v_dtype=v_dtype)))
    else:
        out.append(AuditCheck("kernel-precheck/swan_decode", "skip",
                              "no SWAN config on this engine"))
    out.append(fold("flash_attention", fp.precheck(
        B=1, H=cfg.n_heads, Kv=cfg.n_kv_heads, Sq=max_seq, Sk=max_seq,
        dh=cfg.d_head, dtype=dtype)))
    return out


# ---------------------------------------------------------------------------
# Engine-driven audit
# ---------------------------------------------------------------------------

def _log2_buckets(n: int) -> int:
    """Number of power-of-two buckets in [1, n]."""
    return max(1, int(math.log2(max(1, n))) + 1)


def _graphed(eng) -> bool:
    return eng._graphs is not None


def _no_graphs(eng) -> str:
    return (f"eager engine on {eng.device}: no CUDA graphs to count"
            if eng.device.type == "cuda" else
            "the CPU has no CUDA graphs (eager dispatch only)")


@contextlib.contextmanager
def _eager_bodies(eng, sink: List) -> Iterator[None]:
    """Run each dispatch of ``eng`` eagerly under the cost analyzer (graphs
    bypassed), appending ``(family, key, StepCosts)`` to ``sink``."""
    def dispatch(family, key, fn, inputs, dead_inputs):
        with CostMode() as mode:
            out = fn(*[eng._to_device(x) for x in inputs])
        sink.append((family, key, mode.costs))
        return out
    eng._dispatch = dispatch
    try:
        yield
    finally:
        del eng._dispatch


def dispatch_costs(eng, family: str, page_bucket: Optional[int] = None,
                   n_lanes: int = 1, chunk: int = 1,
                   prefix: Optional[int] = None) -> StepCosts:
    """The cost of one dead-operand dispatch body of ``family`` ("decode"
    or "chunk"), run eagerly (the bucket's graph would replay the same
    ops)."""
    from repro_torch.runtime.warmup import WarmupItem, dead_dispatch
    sink: List = []
    with _eager_bodies(eng, sink):
        if family == "decode":
            dead_dispatch(eng, WarmupItem("decode", page_bucket=page_bucket))
        else:
            dead_dispatch(eng, WarmupItem("chunk", n_lanes=n_lanes,
                                          chunk=chunk,
                                          page_bucket=page_bucket,
                                          prefix=prefix))
    return sink[0][2]


def dispatch_checks(eng, label: str) -> List[AuditCheck]:
    """(ii)+(iii) over the engine's decode and chunk dispatch bodies at
    their smallest buckets, run eagerly under the cost analyzer."""
    out: List[AuditCheck] = []
    pb = 1 if eng.paged else None
    bodies = [("decode", dispatch_costs(eng, "decode", page_bucket=pb))]
    if eng.prefill_chunk is not None:
        c = eng.prefill_chunk
        bodies.append(("chunk", dispatch_costs(
            eng, "chunk", page_bucket=pb, n_lanes=eng.dp, chunk=c,
            prefix=None if eng.paged else c)))
    for fam, costs in bodies:
        out.append(transfer_check(costs, f"{label}/{fam}"))
        out.append(collective_check(costs, f"{label}/{fam}"))
    return out


def _drive(eng, reqs) -> None:
    for r in reqs:
        eng.submit(r)
    while not eng.done:
        eng.step()


def _exec_count_checks(eng, label: str,
                       reqs: Callable[[], list]) -> List[AuditCheck]:
    """(i): drive a mixed-length workload, bound the graph family by
    family through ``executable_census()``, then re-run the identical
    workload and require no new graph."""
    paged = eng.paged
    if not _graphed(eng):
        return [AuditCheck(f"exec-count/{label}", "skip", _no_graphs(eng))]
    _drive(eng, reqs())
    census = eng.executable_census()
    dec_bound = _log2_buckets(eng.pool.pages_per_seq) if paged else 1
    chunk_bound = (_log2_buckets(eng.n_slots)
                   * _log2_buckets(eng.prefill_chunk or 1)
                   * _log2_buckets(eng.pool.pages_per_seq if paged
                                   else eng.max_seq))
    out = [count_check(f"{label}/decode", census["decode"], dec_bound,
                       "decode graphs"),
           count_check(f"{label}/prefill+chunk",
                       census["prefill"] + census["chunk_total"],
                       1 + chunk_bound, "prefill graphs"),
           count_check(f"{label}/insert",
                       census["insert"] + census["insert_paged"],
                       _log2_buckets(eng.max_seq), "insert graphs"),
           count_check(f"{label}/pool-grow", census["pool_grow_total"],
                       _log2_buckets(eng.max_seq), "grow graphs")]
    _drive(eng, reqs())
    census2 = eng.executable_census()
    out.append(AuditCheck(
        f"exec-count/{label}/steady-state",
        "pass" if census2 == census else "fail",
        "no new graph on identical re-run (full census stable)"
        if census2 == census else
        f"identical workload captured again: {census} -> {census2}"))
    return out


def mixed_workload(vocab: int, max_prompt_len: int, seed: int = 0,
                   n: int = 8, k_choices=(None, 4, 8), max_new: int = 5):
    """A randomized mixed serve workload: prompt lengths spanning the
    chunk/page/prefix buckets, mixed per-request k, greedy and temperature
    lanes (token ids from seeded numpy)."""
    import numpy as np

    from repro_torch.runtime.serve_engine import Request
    rng = np.random.RandomState(seed)
    reqs = []
    for u in range(n):
        plen = int(rng.randint(1, max_prompt_len + 1))
        reqs.append(Request(
            uid=f"w{u}", tokens=rng.randint(0, vocab, size=plen).tolist(),
            max_new_tokens=int(rng.randint(2, max_new)),
            temperature=float(rng.choice([0.0, 0.0, 0.7, 1.3])),
            seed=int(rng.randint(0, 2 ** 16)),
            k=k_choices[int(rng.randint(0, len(k_choices)))]))
    return reqs


def warmup_checks(eng, label: str, reqs: Sequence,
                  max_prompt_len: int) -> List[AuditCheck]:
    """The warmup contract on a graphed engine (warmed here unless it
    already is): (a) the census covers the enumerated family bucket by
    bucket; (b) a second ``warmup()`` captures nothing; (c) the mixed
    workload ``reqs`` captures nothing and leaves the census unchanged."""
    from repro_torch.obs import compile_events
    if not _graphed(eng):
        return [AuditCheck(f"warmup/{label}", "skip", _no_graphs(eng))]
    report = eng.warmup_report or eng.warmup(max_prompt_len=max_prompt_len)
    census, exp = eng.executable_census(), report["expected"]
    missing = [f"{fam}: {census[fam]} < {exp[fam]}"
               for fam in ("decode", "prefill", "insert", "insert_paged")
               if census[fam] < exp[fam]]
    missing += [f"chunk[{key}]: {census['chunk'].get(key, 0)} < {n}"
                for key, n in exp["chunk"].items()
                if census["chunk"].get(key, 0) < n]
    out = [AuditCheck(f"warmup/{label}/coverage",
                      "fail" if missing else "pass",
                      "buckets absent from the warmed family: "
                      + "; ".join(missing) if missing else
                      f"census covers the enumerated family "
                      f"({census['total']} graphs)")]
    rep2 = eng.warmup(max_prompt_len=max_prompt_len)
    out.append(AuditCheck(f"warmup/{label}/idempotent",
                          "fail" if rep2["captures"] else "pass",
                          f"second warmup captured {rep2['captures']} "
                          "graph(s)" if rep2["captures"] else
                          "second warmup captured nothing"))
    c0 = compile_events.total()
    lazy0 = sum(eng._graphs.lazy_captures.values())
    _drive(eng, reqs)
    dc = compile_events.total() - c0
    stable = eng.executable_census() == census
    out.append(AuditCheck(
        f"warmup/{label}/zero-capture", "pass" if not dc and stable
        else "fail", f"{len(reqs)}-request mixed workload: {dc} captures, "
        f"census {'stable' if stable else 'DRIFTED'}"))
    out.append(capture_check(f"{label}/mixed", lazy0,
                             sum(eng._graphs.lazy_captures.values())))
    return out


def audit_graphs(eng, label: str, n_layers: int) -> List[AuditCheck]:
    """(ii)+(iii)+(iv) over every captured decode and chunk graph: the
    node census of each (``GraphSet.dot``) must hold the layout's decode
    kernel (split + merge) ``decode_groups`` times per attention layer, or
    its chunk kernel once, as must the launch tally the wrappers recorded
    during its capture, and no device-to-host memcpy, host node or NCCL
    kernel."""
    if not _graphed(eng):
        return [AuditCheck(f"graphs/{label}", "skip", _no_graphs(eng))]
    layout = "paged" if eng.paged else "slab"
    out: List[AuditCheck] = []
    per_layer = {"decode": decode_groups(eng.cfg), "chunk": 1}
    for fam, symbols in (("decode", DECODE_SYMBOLS), ("chunk", CHUNK_SYMBOLS)):
        keys = eng._graphs.keys(fam)
        if not keys:
            out.append(AuditCheck(f"graphs/{label}/{fam}", "fail",
                                  "no graph captured"))
            continue
        want = LAYOUT_KERNELS[layout][fam]
        n_want = per_layer[fam] * n_layers
        bad_k, bad_t, bad_c, nodes = [], [], [], Counter()
        for key in keys:
            census = parse_graph_dot(eng._graphs.dot(fam, key))
            nodes += census.kernels
            tally = eng._graphs.tally(fam, key)
            if fam == "decode":
                n_sym = [census.count(s) for s in symbols]
            else:
                n_sym = [sum(census.count(s) for s in symbols)]
            if (any(n != n_want for n in n_sym)
                    or tally.get(want) != n_want
                    or any(c for k, c in tally.items() if k != want)):
                bad_k.append((key, n_sym, tally))
            if transfer_check(census, "").status != "pass":
                bad_t.append((key, dict(census.memcpy), census.host))
            if census.nccl:
                bad_c.append((key, census.nccl))
        tag = f"{label}/{fam}"
        out.append(AuditCheck(
            f"graph-kernels/{tag}", "fail" if bad_k else "pass",
            f"{len(bad_k)} of {len(keys)} graphs off {n_want} x {want}: "
            f"{bad_k[:3]}" if bad_k else
            f"{len(keys)} graphs, each {n_want} x {want} "
            f"({' + '.join(symbols) if fam == 'decode' else symbols[0]} "
            "nodes and wrapper launches)"))
        out.append(AuditCheck(
            f"host-transfers/{tag}", "fail" if bad_t else "pass",
            f"device-to-host memcpy or host nodes in {bad_t[:3]}" if bad_t
            else f"{len(keys)} graphs: no device-to-host memcpy, no host "
            "node"))
        out.append(AuditCheck(
            f"collectives/{tag}", "fail" if bad_c else "pass",
            f"NCCL kernels in {bad_c[:3]}" if bad_c else
            f"{len(keys)} graphs: no NCCL kernel ({sum(nodes.values())} "
            f"kernel nodes, {len(nodes)} symbols)"))
    return out


def step_sync_checks(eng, label: str, reqs: Sequence) -> List[AuditCheck]:
    """Serve ``reqs`` and count, per ``step()``, the host-blocking calls
    made outside the designed fetch points (``FETCH_POINTS``): the cost
    analyzer's host transfers (``.item()``, device-to-host copies) and, on
    the card, the synchronizing CUDA calls ``torch.cuda``'s sync debug
    mode reports.  Both must be 0, and the fetch points may block at most
    once per dispatch that yields tokens.  The token copies that
    ``_start_fetch`` issues belong to the fetch; on the card they must not
    synchronize."""
    import torch
    cuda = eng.device.type == "cuda"
    mode = CostMode()
    calls = {"fetch": 0}
    depth = [0]

    def wrap(orig, blocking: bool):
        def fetch(*a, **k):
            depth[0] += 1
            if depth[0] == 1 and blocking:
                calls["fetch"] += 1
            prev = torch.cuda.get_sync_debug_mode() if cuda else 0
            try:
                if cuda and blocking:
                    torch.cuda.set_sync_debug_mode(0)
                with mode.paused():
                    return orig(*a, **k)
            finally:
                if cuda and blocking:
                    torch.cuda.set_sync_debug_mode(prev)
                depth[0] -= 1
        return fetch

    # _start_fetch issues the token copies (counted as the fetch, but
    # they must not block); _resolve_tokens and _sample block by design
    wrapped = {"_start_fetch": False, **{n: True for n in FETCH_POINTS}}
    for name, blocking in wrapped.items():
        setattr(eng, name, wrap(getattr(eng, name), blocking))
    for r in reqs:
        eng.submit(r)
    steps, fetches, outside, syncs, over = 0, 0, 0, 0, []
    try:
        while not eng.done:
            d0 = sum(eng.dispatches.values())
            calls["fetch"] = 0
            h0 = mode.costs.host_transfers
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                if cuda:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    with mode:
                        eng.step()
                finally:
                    if cuda:
                        torch.cuda.set_sync_debug_mode(0)
            n_sync = sum("called a synchronizing CUDA operation"
                         in str(w.message) for w in rec)
            steps += 1
            fetches += calls["fetch"]
            outside += mode.costs.host_transfers - h0
            syncs += n_sync
            if calls["fetch"] > sum(eng.dispatches.values()) - d0 + (
                    1 if eng.async_fetch else 0):
                over.append(steps)
    finally:
        for name in wrapped:
            delattr(eng, name)
    bad = []
    if outside:
        bad.append(f"{outside} host transfer(s) outside the fetch points")
    if syncs:
        bad.append(f"{syncs} synchronizing CUDA call(s) outside the fetch "
                   "points")
    if over:
        bad.append(f"more fetches than token dispatches in steps {over[:5]}")
    how = ("cost analyzer + CUDA sync debug mode" if cuda
           else "cost analyzer")
    return [AuditCheck(f"host-sync/{label}", "fail" if bad else "pass",
                       "; ".join(bad) if bad else
                       f"{steps} steps: {fetches} designed token fetches, "
                       f"no other host-blocking call ({how})")]


def run_audit(device: str = "cuda", arch: str = "llama3-8b",
              smoke: bool = True, model=None, swan=None,
              max_seq: Optional[int] = None, page_size: Optional[int] = None,
              n_slots: int = 2, prefill_chunk: Optional[int] = None,
              prefill_slots: int = 2, max_prompt_len: Optional[int] = None,
              engines: Optional[Dict[str, Any]] = None,
              reqs: Optional[Callable[[], list]] = None,
              rows: Optional[Sequence[str]] = None) -> List[AuditCheck]:
    """Build the engine matrix and run every check.  Variants: ``slab``
    and ``paged`` read SWAN through the plain PyTorch path, ``slab-kernel``
    and ``paged-kernel`` through the kernels (the card only: graphed, after
    ``warmup(max_prompt_len)``); ``paged-dp2`` and ``paged-dp2-kernel``
    are the paged rows on a two-shard mesh laid over the engine's own
    device (``make_serve_mesh(2, devices=[device] * 2)``), with the same
    checks, summed up by ``engine/paged-dp2``.

    ``smoke`` (default) builds ``arch``'s smoke config in float32 with
    seeded weights and calibrated projections, as the reference does;
    ``model=(cfg, params, projections)`` audits a given model instead (at
    the shapes given).  ``engines`` may hold already warmed graphed kernel
    engines ({"slab": eng, "paged": eng, "paged-dp2": eng}, their
    ``GraphSet.keep_census`` set before their warmup); ``reqs()`` gives
    the driven workload; ``rows`` picks layouts ("slab", "paged",
    "paged-dp2"; default all), ``engine/paged-dp2`` coming with the
    ``paged-dp2`` row."""
    import torch

    from repro_torch.configs import SwanConfig, get_config, get_smoke_config
    from repro_torch.launch.io import make_batch
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.runtime.serve_engine import ServeEngine
    from repro_torch.runtime.serve_loop import calibrate_swan

    dev = torch.device(device)
    if model is None:
        cfg = (get_smoke_config(arch).replace(dtype="float32",
                                              param_dtype="float32")
               if smoke else get_config(arch))
        api = get_model(cfg)
        params = api.init_params(cfg, 0, dev)
        proj = calibrate_swan(api, cfg, params,
                              make_batch(cfg, 2, 24, seed=3, device=dev))
        params = api.absorb(params, cfg, proj)
        model = (cfg, params, proj)
    cfg = model[0]
    swan = swan or SwanConfig(k_max=cfg.d_head, buffer=4, mode="topk")
    max_seq = max_seq or 64
    page_size = page_size or 16
    prefill_chunk = prefill_chunk or 8
    max_prompt_len = max_prompt_len or 16
    n_layers = sum(1 for i in range(cfg.n_layers)
                   if cfg.layer_kind(i) == "attn")
    if reqs is None:
        def reqs():
            return mixed_workload(cfg.vocab_size, max_prompt_len,
                                  k_choices=(None, swan.k_max // 2,
                                             swan.k_max))

    def make(graphs: bool, **kw):
        return ServeEngine(cfg, model[1], swan=swan, projections=model[2],
                           n_slots=n_slots, max_seq=max_seq,
                           prefill_chunk=prefill_chunk,
                           prefill_slots=prefill_slots, graphs=graphs,
                           metrics=False, device=dev, **kw)

    checks = kernel_precheck_checks(
        cfg, swan, max_seq, page_size=page_size,
        chunk_q=prefill_chunk * (cfg.n_heads // cfg.n_kv_heads))
    on_card = dev.type == "cuda"
    layouts = {"slab": {}, "paged": dict(paged=True, page_size=page_size),
               "paged-dp2": dict(paged=True, page_size=page_size,
                                 mesh=make_serve_mesh(2, [dev, dev]))}
    if rows is not None:
        layouts = {k: v for k, v in layouts.items() if k in rows}
    # the detector's page bucket: the largest, so the view outgrows logits
    pb = max_seq // page_size
    view = n_slots * cfg.n_kv_heads * pb * page_size * swan.k_max
    for layout, kw in layouts.items():
        # plain reads (the reference's "xla" variants): eager bodies
        with plain_reads():
            eng = make(False, **kw)
            checks += dispatch_checks(eng, layout)
            if not on_card:
                # the CPU's only engine: graph checks skip, the per-step
                # host-sync census runs through the cost analyzer
                checks += _exec_count_checks(eng, layout, reqs)
                checks += warmup_checks(eng, layout, reqs(), max_prompt_len)
                checks += audit_graphs(eng, layout, n_layers)
                checks += step_sync_checks(eng, layout, reqs())
            if kw:
                checks.append(logical_view_check(
                    dispatch_costs(eng, "decode", page_bucket=pb),
                    f"{layout}/decode@pg{pb}", view,
                    expect_materialized=True))
            del eng
        label = f"{layout}-kernel"
        if not on_card:
            checks.append(AuditCheck(f"engine/{label}", "skip",
                                     "the kernels need a CUDA device (on "
                                     "the CPU the wrappers run their plain "
                                     "twins)"))
            continue
        eng = (engines or {}).get(layout)
        if eng is None:
            eng = make(True, **kw)
            eng._graphs.keep_census = True
            eng.warmup(max_prompt_len=max_prompt_len)
        checks += dispatch_checks(eng, label)
        checks += audit_graphs(eng, label, n_layers)
        checks += warmup_checks(eng, label, reqs(), max_prompt_len)
        checks += step_sync_checks(eng, label, reqs())
        checks += _exec_count_checks(eng, label, reqs)
        if kw:
            checks.append(logical_view_check(
                dispatch_costs(eng, "decode", page_bucket=pb),
                f"{label}/decode@pg{pb}", view))
        del eng
    if "paged-dp2" not in layouts:
        return checks
    dp2 = [c for c in checks if "/paged-dp2" in c.check]
    bad = [c.check for c in dp2 if c.status == "fail"]
    checks.append(AuditCheck(
        "engine/paged-dp2", "fail" if bad else "pass",
        f"failed: {bad}" if bad else
        f"two shards on {dev}, {n_slots // 2} slots each: "
        f"{sum(c.status == 'pass' for c in dp2)} checks pass, "
        f"{sum(c.status == 'skip' for c in dp2)} skip"))
    return checks
