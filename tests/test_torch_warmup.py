"""The port's graph-family warmup, census and asynchronous token fetch
(``repro_torch.runtime.{warmup,graphs}``, ``ServeEngine(graphs=...,
async_fetch=...)``) against the JAX reference's ``repro.runtime.warmup``
and ``ServeEngine(async_fetch=True)``, on a tiny float32 llama3-8b smoke
config.

* ``executable_family`` gives the reference's items (kind, bucket,
  ``detail``), ``expected`` and ``skipped`` for the same configuration;
* every warmup item's dead-lane dispatch, run eagerly on a serving engine,
  leaves its state bit-identical (the paged trash page aside);
* ``async_fetch=True`` matches the reference's async engine: tokens,
  completion steps, engine steps, dispatches; temperature lanes are
  compared on the logits rows they sample from (torch cannot reproduce
  ``jax.random``);
* ``census``/``warmup`` raise on an eager engine, ``graphs=True`` raises
  without a card;
* the graph bookkeeping (static operands, capture on dead-lane operands,
  replay, census keys, re-warm after pool growth) runs here through an
  emulated graph set whose "capture" runs the dispatch on its dead-lane
  operands and whose "replay" runs it again on the static buffers.  It
  checks the engine's plumbing, not CUDA: the card's graphs are held to
  the eager engine by ``chip_smoke.py``'s graphs phase.
"""
from collections import Counter

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import SwanConfig as JSwan  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch.io import make_batch as j_make_batch  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.runtime.serve_engine import Request as JRequest  # noqa: E402
from repro.runtime.serve_engine import ServeEngine as JEngine  # noqa: E402
from repro.runtime.serve_loop import calibrate_swan as j_calibrate  # noqa: E402
from repro.runtime.warmup import _pow2_buckets as j_pow2_buckets  # noqa: E402
from repro.runtime.warmup import executable_family as j_family  # noqa: E402
from repro_torch.configs import SwanConfig, get_smoke_config  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core.paged_cache import TRASH_PAGE  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.runtime.graphs import GraphSet, _Graph  # noqa: E402
from repro_torch.runtime.serve_engine import Request, ServeEngine  # noqa: E402
from repro_torch.runtime.serve_loop import ServeSession  # noqa: E402
from repro_torch.runtime.warmup import (_pow2_buckets,  # noqa: E402
                                        dead_dispatch, executable_family)

MAX_SEQ, N_SLOTS, CHUNK, PAGE, PROMPT_CAP = 64, 4, 8, 8, 16


@pytest.fixture(scope="module")
def ref():
    dims = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                d_ff=128, dtype="float32", param_dtype="float32")
    jcfg = j_smoke("llama3-8b").replace(**dims)
    tcfg = get_smoke_config("llama3-8b").replace(**dims)
    japi = j_get_model(jcfg)
    params = japi.init_params(jax.random.PRNGKey(0), jcfg)
    pj = j_calibrate(japi, jcfg, params, j_make_batch(jcfg, 2, 24, seed=3))
    absorbed = japi.absorb(params, jcfg, pj)
    t = {n: to_torch(x, device="cpu") for n, x in
         (("params", params), ("absorbed", absorbed), ("pj", pj))}
    return {"jcfg": jcfg, "tcfg": tcfg, "params": params,
            "absorbed": absorbed, "pj": pj, "t": t}


def _engine(ref, jax_side: bool, dense: bool = False, **kw):
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("n_slots", N_SLOTS)
    if jax_side:
        cls, cfg, w, swan_cls = JEngine, ref["jcfg"], ref, JSwan
    else:
        cls, cfg, w, swan_cls = ServeEngine, ref["tcfg"], ref["t"], SwanConfig
        kw.setdefault("device", "cpu")
    if dense:
        return cls(cfg, w["params"], **kw)
    return cls(cfg, w["absorbed"], swan=swan_cls(k_max=8, buffer=4),
               projections=w["pj"], **kw)


def _workload(cls, cfg, seed: int, n: int = 6, max_len: int = 20):
    """Mixed prompt lengths, per-request k, greedy and temperature lanes."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.randint(1, max_len + 1))
        toks = [int(x) for x in np.asarray(
            j_make_batch(cfg, 1, plen, seed=300 + i)["tokens"][0])]
        reqs.append(cls(uid=f"req{i}", tokens=toks,
                        max_new_tokens=int(rng.randint(2, 6)),
                        temperature=0.7 if i % 3 == 1 else 0.0,
                        seed=int(rng.randint(0, 2**31 - 1)),
                        k=[None, 4, 8][int(rng.randint(0, 3))]))
    return reqs


# ---------------------------------------------------------------------------
# (a) the family equals the reference's
# ---------------------------------------------------------------------------

FAMILIES = [
    (layout, chunk, slots, cap)
    for layout in ("slab", "paged")
    for chunk, slots in ((None, 1), (CHUNK, 1), (CHUNK, 2), (CHUNK, 3))
    for cap in (None, PROMPT_CAP)
]


def _items(fam):
    return [(i.kind, i.page_bucket, i.n_lanes, i.chunk, i.prefix, i.pad_len,
             i.width, i.src, i.detail) for i in fam["items"]]


@pytest.mark.parametrize("layout,chunk,slots,cap", FAMILIES)
def test_family_matches_reference(ref, layout, chunk, slots, cap):
    kw = dict(prefill_chunk=chunk, prefill_slots=slots)
    if layout == "paged":
        kw.update(paged=True, page_size=PAGE)
    want = j_family(_engine(ref, True, **kw), max_prompt_len=cap)
    got = executable_family(_engine(ref, False, **kw), max_prompt_len=cap)
    assert _items(got) == _items(want)
    assert got["expected"] == want["expected"]
    assert got["skipped"] == want["skipped"]


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_unbucketed_family_matches_reference(ref, layout):
    kw = dict(bucket_prompts=False)
    if layout == "paged":
        kw.update(paged=True, page_size=PAGE)
    want = j_family(_engine(ref, True, **kw))
    got = executable_family(_engine(ref, False, **kw))
    assert _items(got) == _items(want) and got["skipped"] == want["skipped"]
    assert got["skipped"] and got["expected"] == want["expected"]


def test_pow2_buckets_match_reference():
    for cap in (1, 2, 3, 5, 8, 12, 64, 100):
        assert _pow2_buckets(cap) == j_pow2_buckets(cap)


# ---------------------------------------------------------------------------
# (c) every dead-lane dispatch is a no-op on a serving engine
# ---------------------------------------------------------------------------

def _snapshot(tree):
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    return tree.clone()


def _assert_state_equal(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            _assert_state_equal(a[k], b[k], f"{path}/{k}")
        return
    if path.startswith("/pool"):               # [L, n_pages, ...]
        a, b = a[:, TRASH_PAGE + 1:], b[:, TRASH_PAGE + 1:]
    assert torch.equal(a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn
                       else a, b.view(torch.uint8)
                       if b.dtype == torch.float8_e4m3fn else b), path


NOOP_CONFIGS = {
    "slab_chunked": dict(prefill_chunk=CHUNK, prefill_slots=3),
    "paged_chunked": dict(paged=True, page_size=PAGE, prefill_chunk=CHUNK,
                          prefill_slots=2),
    "slab_monolithic": dict(),
    "paged_monolithic": dict(paged=True, page_size=PAGE),
    "dense_chunked": dict(prefill_chunk=CHUNK, prefill_slots=2),
}


@pytest.mark.parametrize("name", list(NOOP_CONFIGS))
def test_dead_dispatches_leave_state_unchanged(ref, name):
    kw = NOOP_CONFIGS[name]
    dense = name.startswith("dense")
    reqs = lambda: _workload(Request, ref["jcfg"], seed=5, n=7,  # noqa: E731
                             max_len=30)
    eng = _engine(ref, False, dense=dense, **kw)
    twin = _engine(ref, False, dense=dense, **kw)
    for e in (eng, twin):
        for r in reqs():
            if dense:
                r.k = None                  # per-request k needs SWAN
            e.submit(r)
        for _ in range(4):                  # mid-flight: prefills, decodes
            e.step()
    assert any(s is not None for s in eng.slots)
    before = _snapshot(eng.state)
    fam = executable_family(eng, max_prompt_len=PROMPT_CAP)
    items = [i for i in fam["items"] if i.kind in ("decode", "chunk",
                                                   "prefill")]
    assert {i.kind for i in items} >= {"decode"}
    for item in items:
        dead_dispatch(eng, item)
    _assert_state_equal(eng.state, before)
    done = {c.uid: (c.tokens, c.first_token_step, c.finished_step)
            for c in eng.run()}
    want = {c.uid: (c.tokens, c.first_token_step, c.finished_step)
            for c in twin.run()}
    assert done == want


# ---------------------------------------------------------------------------
# (d) async fetch against the reference's async engine
# ---------------------------------------------------------------------------

def _record_temperature_rows(eng, rows):
    """Temperature draws record the logits row they sample from and take
    its argmax, so both engines keep feeding the same tokens."""
    orig = eng._sample

    def sample(logits, req, n_prev):
        if req.temperature <= 0.0:
            return orig(logits, req, n_prev)
        row = np.array(logits, np.float32)       # a copy: the fetch
        rows[(req.uid, n_prev)] = row               # buffer is reused
        return int(np.argmax(row))
    eng._sample = sample


ASYNC_CONFIGS = {
    "slab_chunked_2": dict(prefill_chunk=CHUNK, prefill_slots=2),
    "paged_monolithic": dict(paged=True, page_size=PAGE),
}


@pytest.mark.parametrize("graphs", ["eager", "emulated_graphs"])
@pytest.mark.parametrize("name", list(ASYNC_CONFIGS))
def test_async_fetch_matches_reference(ref, name, graphs):
    kw = dict(ASYNC_CONFIGS[name], async_fetch=True)
    key = ("async", name)
    if key not in ref:
        j_rows = {}
        jeng = _engine(ref, True, **kw)
        _record_temperature_rows(jeng, j_rows)
        comps = jeng.run(_workload(JRequest, ref["jcfg"], seed=7))
        assert jeng.done and jeng._pending is None
        ref[key] = (_completions(comps), jeng.step_count,
                    dict(jeng.dispatches), j_rows)
    want, want_steps, want_disp, j_rows = ref[key]
    eng = _engine(ref, False, **kw)
    if graphs == "emulated_graphs":
        eng._graphs = EmulatedGraphs(eng.device)
    t_rows = {}
    _record_temperature_rows(eng, t_rows)
    comps = eng.run(_workload(Request, ref["jcfg"], seed=7))
    assert eng.done and eng._pending is None
    assert _completions(comps) == want
    assert eng.step_count == want_steps
    assert eng.dispatches == want_disp
    assert j_rows and sorted(t_rows) == sorted(j_rows)
    for k, row in j_rows.items():
        np.testing.assert_allclose(t_rows[k], row, atol=5e-5)


def _completions(comps):
    return {c.uid: (c.tokens, c.admitted_step, c.first_token_step,
                    c.finished_step) for c in comps}


def test_async_fetch_equals_sync_in_the_port(ref):
    reqs = lambda: _workload(Request, ref["jcfg"], seed=11)  # noqa: E731
    kw = dict(paged=True, page_size=PAGE, prefill_chunk=CHUNK,
              prefill_slots=2)
    sync = _engine(ref, False, **kw)
    asy = _engine(ref, False, async_fetch=True, **kw)
    assert _completions(sync.run(reqs())) == _completions(asy.run(reqs()))
    assert sync.dispatches == asy.dispatches


# ---------------------------------------------------------------------------
# (e) no graphs without a card, no census without graphs
# ---------------------------------------------------------------------------

def test_census_and_warmup_raise_on_an_eager_engine(ref):
    eng = _engine(ref, False)
    with pytest.raises(RuntimeError, match="graphs"):
        eng.executable_census()
    with pytest.raises(RuntimeError, match="graphs"):
        eng.warmup()
    assert eng.decode_cache_size == 0 and eng.prefill_cache_size == 0


def test_graphs_need_a_card(ref):
    with pytest.raises(RuntimeError, match="CUDA"):
        _engine(ref, False, graphs=True)
    t = ref["t"]
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeSession(ref["tcfg"], t["params"], max_seq=MAX_SEQ, batch=2,
                     graphs=True, device="cpu")


@pytest.mark.parametrize("argv", [
    ["--warmup"],                                    # needs --engine
    ["--async-fetch"],                               # needs --engine
    ["--engine", "--warmup"],                        # needs graphs (a card)
])
def test_launcher_graph_flag_checks(argv):
    with pytest.raises(SystemExit):
        serve_cli.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                        *argv])


def test_launcher_async_fetch_runs_on_cpu(capsys):
    serve_cli.main(["--arch", "llama3-8b", "--smoke", "--swan", "--k", "8",
                    "--buffer", "8", "--tokens", "4", "--batch", "2",
                    "--prompt-len", "20", "--max-seq", "128", "--device",
                    "cpu", "--engine", "--requests", "3", "--prefill-chunk",
                    "16", "--async-fetch"])
    out = capsys.readouterr().out
    assert "engine: 3 requests, 12 tokens" in out and "eager" in out


# ---------------------------------------------------------------------------
# the engine's graph plumbing, through an emulated graph set
# ---------------------------------------------------------------------------

class _HostGraph:
    def __init__(self, fn, inputs, outputs):
        self.fn, self.inputs, self.outputs = fn, inputs, outputs

    def replay(self):
        new = self.fn(*self.inputs)
        if self.outputs is not None:
            for o, n in zip(_flat(self.outputs), _flat(new)):
                o.copy_(n)


def _flat(x):
    return [x] if isinstance(x, torch.Tensor) else list(x)


class EmulatedGraphs(GraphSet):
    """``GraphSet`` with its capture emulated on the host: the warm run,
    then one more run on the dead-lane operands whose outputs become the
    static outputs; a replay runs the dispatch on the static buffers and
    copies its outputs into them."""

    def __init__(self, device):
        self.device = device
        self._graphs = {}
        self.captures, self.lazy_captures = Counter(), Counter()
        self.replays = Counter()
        self.capture_s, self.warming = 0.0, False

    def drop(self):
        self._graphs.clear()

    def _record(self, fn, inputs):
        fn(*inputs)
        out = fn(*inputs)
        if out is not None:
            out = tuple(o.clone() for o in _flat(out))
            out = out[0] if len(out) == 1 else out
        return _Graph(_HostGraph(fn, inputs, out), inputs, out, {})


GRAPHED_CONFIGS = {
    "slab_chunked_3": dict(prefill_chunk=CHUNK, prefill_slots=3),
    "paged_monolithic": dict(paged=True, page_size=PAGE),
    "paged_chunked_pool_grow": dict(paged=True, page_size=PAGE, n_pages=3,
                                    pool_grow=True, prefill_chunk=CHUNK,
                                    prefill_slots=2),
}


@pytest.mark.parametrize("name", list(GRAPHED_CONFIGS))
def test_warmed_graphs_capture_nothing_mid_serve(ref, name):
    kw = GRAPHED_CONFIGS[name]
    reqs = lambda: _workload(Request, ref["jcfg"], seed=13,  # noqa: E731
                             max_len=PROMPT_CAP)
    eager = _engine(ref, False, **kw)
    want = _completions(eager.run(reqs()))
    eng = _engine(ref, False, **kw)
    eng._graphs = EmulatedGraphs(eng.device)
    rep = eng.warmup(max_prompt_len=PROMPT_CAP)
    census, expected = rep["census"], rep["expected"]
    for b in ("decode", "prefill", "insert", "insert_paged"):
        assert census[b] >= expected[b], b
    for b, n in expected["chunk"].items():
        assert census["chunk"].get(b, 0) >= n, b
    assert rep["captures"] == census["total"] > 0
    assert eng.warmup(max_prompt_len=PROMPT_CAP)["captures"] == 0
    assert _completions(eng.run(reqs())) == want
    assert eng.dispatches == eager.dispatches
    assert eng.cache_report() == eager.cache_report()
    assert sum(eng._graphs.lazy_captures.values()) == 0
    if "pool_grow" in name:
        assert eng.pool.n_pages > kw["n_pages"]     # grew, and re-warmed
        assert eng.executable_census()["pool_grow_total"] == 0


def test_unwarmed_graphs_capture_at_first_use(ref):
    kw = dict(prefill_chunk=CHUNK, prefill_slots=2)
    reqs = lambda: _workload(Request, ref["jcfg"], seed=17)  # noqa: E731
    want = _completions(_engine(ref, False, **kw).run(reqs()))
    eng = _engine(ref, False, **kw)
    eng._graphs = EmulatedGraphs(eng.device)
    assert eng.executable_census()["total"] == 0
    assert _completions(eng.run(reqs())) == want
    census = eng.executable_census()
    lazy = eng._graphs.lazy_captures
    assert census["decode"] == eng.decode_cache_size == 1
    assert census["chunk_total"] == eng.prefill_cache_size == lazy["chunk"]
    assert sum(lazy.values()) == census["total"]
    assert eng._graphs.replays["decode"] == eng.dispatches["decode"]
    assert eng._graphs.replays["chunk"] == eng.dispatches["chunk"]
