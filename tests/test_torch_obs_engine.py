"""Observability x the port's ``ServeEngine`` and ``ServeSession``
(``repro_torch.obs``), after ``tests/test_obs_engine.py``: metrics and
tracing observe the engine without taking part in it (on vs off: the same
tokens, dispatches, steps and ``cache_report()``, slab and paged, eager
and through the emulated graph set of ``tests/test_torch_warmup.py``);
per-request accounting (``first_token_step`` once, gaps matching the
trace, retire == completions); ``cache_report()`` == the per-step gauges;
page counters balanced; pool growth counted; registries round-trip and
can be shared; the session's counters.

Against the reference: one JAX engine and one port engine, on the same
converted weights of the f32 smoke config, serve the reference's mixed
paged, chunked trace.  Every step-indexed family is equal after
``RENAMED_FROM_REFERENCE``; the wall-clock families (dispatch and fetch
ms, the session's call ms) have equal label sets and observation counts;
the event traces are the same sequence.  ``serve_compile_total`` is left
out there (the reference counts XLA compiles on the CPU): the emulated
graph set holds it to the captures instead."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import SwanConfig as JSwan  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch.io import make_batch as j_make_batch  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.obs import EventTrace as JTrace  # noqa: E402
from repro.runtime.serve_engine import Request as JRequest  # noqa: E402
from repro.runtime.serve_engine import ServeEngine as JEngine  # noqa: E402
from repro.runtime.serve_loop import ServeSession as JSession  # noqa: E402
from repro.runtime.serve_loop import calibrate_swan as j_calibrate  # noqa: E402
from repro_torch.configs import SwanConfig, get_smoke_config  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.obs import (EventTrace, MetricsRegistry,  # noqa: E402
                             compile_events, parse_prometheus)
from repro_torch.runtime.serve_engine import (  # noqa: E402
    RENAMED_FROM_REFERENCE, Request, ServeEngine)
from repro_torch.runtime.serve_loop import ServeSession  # noqa: E402
pytest.register_assert_rewrite("test_torch_warmup")
from test_torch_warmup import EmulatedGraphs  # noqa: E402

PAGE = 16
_SPEC = [(6, 8, 8, 0), (11, 5, 4, 0), (17, 9, None, 2), (9, 6, 2, 4)]
_ENGINE_KW = dict(max_seq=64, n_slots=2, paged=True, page_size=PAGE,
                  prefill_chunk=8, prefill_slots=2)
# families timed on the host's clock: equal label sets and counts only
WALL_CLOCK = {"serve_dispatch_ms", "serve_token_fetch_ms",
              "session_prefill_call_ms", "session_decode_call_ms",
              "serve_warmup_ms"}


@pytest.fixture(scope="module")
def ref():
    jcfg = j_smoke("llama3-8b").replace(dtype="float32", param_dtype="float32")
    tcfg = get_smoke_config("llama3-8b").replace(dtype="float32",
                                                 param_dtype="float32")
    japi = j_get_model(jcfg)
    params = japi.init_params(jax.random.PRNGKey(0), jcfg)
    pj = j_calibrate(japi, jcfg, params, j_make_batch(jcfg, 2, 24, seed=3))
    absorbed = japi.absorb(params, jcfg, pj)
    prompts = [np.asarray(j_make_batch(jcfg, 1, n, seed=20 + i)["tokens"][0]
                          ).tolist() for i, (n, _, _, _) in enumerate(_SPEC)]
    t = {n: to_torch(x, device="cpu") for n, x in
         (("params", params), ("absorbed", absorbed), ("pj", pj))}
    return {"jcfg": jcfg, "tcfg": tcfg, "params": params, "absorbed": absorbed,
            "pj": pj, "t": t, "prompts": prompts}


def _mixed_trace(ref, cls=Request):
    """Mixed prompt lengths, mixed per-request k, staggered arrivals."""
    return [cls(uid=f"m{i}", tokens=list(ref["prompts"][i]),
                max_new_tokens=g, k=k, arrival_step=a)
            for i, (_, g, k, a) in enumerate(_SPEC)]


def _engine(ref, graphs=False, **kw):
    """A port engine on the CPU: eager, or through the emulated graphs."""
    t = ref["t"]
    eng = ServeEngine(ref["tcfg"], t["absorbed"],
                      swan=SwanConfig(k_max=8, buffer=4), projections=t["pj"],
                      device="cpu", **kw)
    if graphs:
        eng._graphs = EmulatedGraphs(eng.device)
    return eng


@pytest.fixture(scope="module")
def obs_run(ref):
    """One drained, fully instrumented engine on paged + chunked + batched
    concurrent prefill."""
    trace = EventTrace()
    eng = _engine(ref, trace=trace, **_ENGINE_KW)
    comps = eng.run(_mixed_trace(ref))
    return eng, trace, comps


@pytest.fixture(scope="module")
def ref_run(ref):
    """The reference engine on the same trace (once per module)."""
    trace = JTrace()
    eng = JEngine(ref["jcfg"], ref["absorbed"],
                  swan=JSwan(k_max=8, buffer=4, mode="topk"),
                  projections=ref["pj"], trace=trace, **_ENGINE_KW)
    comps = eng.run(_mixed_trace(ref, JRequest))
    return eng, trace, comps


def _steps(comps):
    return [(c.uid, c.tokens, c.admitted_step, c.first_token_step,
             c.finished_step) for c in comps]


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def _renamed(snap):
    """A reference snapshot under the port's names."""
    out = {}
    for name, fam in snap["metrics"].items():
        series = [dict(ser, labels={k: RENAMED_FROM_REFERENCE.get(v, v)
                                    for k, v in ser["labels"].items()})
                  for ser in fam["series"]]
        out[RENAMED_FROM_REFERENCE.get(name, name)] = dict(fam, series=series)
    return out


def _assert_families_match(port_snap, ref_snap, skip=()):
    want = {n: f for n, f in _renamed(ref_snap).items() if n not in skip}
    got = port_snap["metrics"]
    assert sorted(got) == sorted(want)
    for name, fam in want.items():
        g = got[name]
        assert (g["kind"], g.get("buckets")) == (fam["kind"],
                                                 fam.get("buckets")), name
        if name not in WALL_CLOCK:
            assert g["series"] == fam["series"], name
            continue
        key = (lambda s: (sorted(s["labels"].items()), s.get("count")))
        assert sorted(map(key, g["series"])) == sorted(map(key, fam["series"])), \
            name


def test_engine_metrics_match_reference(obs_run, ref_run):
    eng, _, comps = obs_run
    jeng, _, jcomps = ref_run
    assert _steps(comps) == _steps(jcomps)
    assert eng.dispatches == jeng.dispatches
    _assert_families_match(eng.metrics.snapshot(), jeng.metrics.snapshot(),
                           skip={"serve_compile_total"})
    assert eng.metrics.get("serve_compile_total", phase="serve",
                           kind="decode") is None        # eager: no capture


def test_engine_trace_matches_reference(obs_run, ref_run):
    _, trace, _ = obs_run
    _, jtrace, _ = ref_run
    assert len(trace.events) > 50
    assert trace.events == jtrace.events


def test_session_metrics_match_reference(ref):
    t = ref["t"]
    sess = ServeSession(ref["tcfg"], t["params"], max_seq=64, batch=2,
                        metrics=True, device="cpu")
    jsess = JSession(ref["jcfg"], ref["params"], max_seq=64, batch=2,
                     metrics=True)
    batch = j_make_batch(ref["jcfg"], 2, 8, seed=7)
    out = sess.generate({"tokens": torch.from_numpy(
        np.array(batch["tokens"]))}, 5)
    jout = jsess.generate(batch, 5)
    assert out.shape == (2, 5) and out.tolist() == np.asarray(jout).tolist()
    m = sess.metrics
    assert m.value("session_prefill_total") == 1
    assert m.value("session_decode_total") == 4      # n_tokens - 1 decodes
    assert m.value("session_tokens_generated_total") == 10
    assert m.get("session_decode_call_ms").count == 4
    _assert_families_match(m.snapshot(), jsess.metrics.snapshot())
    # off by default: no registry unless asked
    off = ServeSession(ref["tcfg"], t["params"], max_seq=64, batch=1,
                       device="cpu")
    assert not off.metrics.enabled


# ---------------------------------------------------------------------------
# the contract: observation never takes part
# ---------------------------------------------------------------------------

LAYOUTS = {"slab": dict(prefill_chunk=8, prefill_slots=2),
           "paged": _ENGINE_KW}


@pytest.mark.parametrize("graphs", ["eager", "emulated_graphs"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_metrics_on_vs_off_identity(ref, layout, graphs):
    kw = dict(LAYOUTS[layout], max_seq=64, n_slots=2)
    runs = []
    for metrics, trace in ((True, EventTrace()), (False, None)):
        eng = _engine(ref, graphs=graphs != "eager", metrics=metrics,
                      trace=trace, **kw)
        comps = eng.run(_mixed_trace(ref))
        runs.append((_steps(comps), dict(eng.dispatches), eng.step_count,
                     eng.cache_report(), eng))
    (on, off) = runs
    assert on[:4] == off[:4]
    assert on[4].metrics.value("serve_engine_steps") == on[2]
    # off really is off: the null registry never accumulates state
    assert not off[4].metrics.enabled
    assert off[4].metrics.snapshot() == {"metrics": {}}


def test_first_token_step_set_exactly_once_concurrent(obs_run):
    eng, trace, comps = obs_run
    arrivals = {f"m{i}": a for i, (_, _, _, a) in enumerate(_SPEC)}
    for c in comps:
        evs = trace.select("first_token", uid=c.uid)
        assert len(evs) == 1, f"{c.uid}: first_token emitted {len(evs)}x"
        assert evs[0]["step"] == c.first_token_step
        assert evs[0]["ttft_steps"] == c.first_token_step - arrivals[c.uid]
        assert c.admitted_step <= c.first_token_step <= c.finished_step
        tok0 = trace.select("token", uid=c.uid, index=0)
        assert len(tok0) == 1 and tok0[0]["step"] == c.first_token_step
        assert tok0[0]["token"] == c.tokens[0]
    ttft = eng.metrics.get("serve_ttft_steps")
    assert ttft.count == len(comps)
    assert ttft.sum == sum(c.first_token_step - arrivals[c.uid]
                           for c in comps)


@pytest.mark.parametrize("chunk", [None, 8],
                         ids=["monolithic", "chunked_serial"])
def test_first_token_step_set_exactly_once(ref, chunk):
    trace = EventTrace()
    eng = _engine(ref, max_seq=64, n_slots=2, prefill_chunk=chunk,
                  trace=trace)
    comps = eng.run(_mixed_trace(ref))
    assert len(comps) == len(_SPEC)
    for c in comps:
        evs = trace.select("first_token", uid=c.uid)
        assert len(evs) == 1
        assert evs[0]["step"] == c.first_token_step >= c.admitted_step
    assert eng.metrics.get("serve_ttft_steps").count == len(comps)
    mode = "monolithic" if chunk is None else "chunked"
    assert eng.metrics.value("serve_admissions_total", mode=mode) == len(_SPEC)


def test_inter_token_gaps_match_trace(obs_run):
    eng, trace, comps = obs_run
    gaps = []
    for c in comps:
        steps = [e["step"] for e in trace.select("token", uid=c.uid)]
        assert len(steps) == len(c.tokens)
        assert steps == sorted(steps)
        gaps += [b - a for a, b in zip(steps, steps[1:])]
    h = eng.metrics.get("serve_inter_token_steps")
    assert h.count == len(gaps) and h.sum == sum(gaps)
    assert all(g >= 0 for g in gaps)
    assert eng.metrics.value("serve_tokens_generated_total") \
        == sum(len(c.tokens) for c in comps)


def test_retire_events_match_completions(obs_run):
    eng, trace, comps = obs_run
    for c in comps:
        (ev,) = trace.select("retire", uid=c.uid)
        assert ev["n_tokens"] == len(c.tokens)
        assert ev["step"] == c.finished_step
        assert ev["first_token_step"] == c.first_token_step
        assert ev["reason"] in ("eos", "max_tokens", "max_seq")
    done = sum(s.value for s in
               eng.metrics._families["serve_completions_total"]
               ["series"].values())
    assert done == len(comps)
    assert eng.metrics.get("serve_request_steps").count == len(comps)


# ---------------------------------------------------------------------------
# byte accounting: one source
# ---------------------------------------------------------------------------

def test_cache_report_matches_gauges_paged(obs_run):
    eng, _, _ = obs_run
    rep = eng.cache_report()
    m = eng.metrics
    assert m.value("kv_cache_reserved_bytes") == rep["reserved_bytes"]
    assert m.value("kv_cache_live_bytes") == rep["live_bytes"]
    assert m.value("page_table_shipped_bytes") \
        == rep["page_table_shipped_bytes"]
    assert m.value("page_pool_live_pages") == rep["live_pages"] == 0
    assert m.value("shard_kv_cache_reserved_bytes", shard=0) \
        == rep["shards"][0]["reserved_bytes"] == rep["reserved_bytes"]
    assert m.value("shard_kv_cache_live_bytes", shard=0) \
        == rep["shards"][0]["live_bytes"]
    assert m.value("serve_engine_steps") == eng.step_count


def test_slab_gauges_reserved_equals_live(ref):
    eng = _engine(ref, max_seq=64, n_slots=2)
    eng.run(_mixed_trace(ref))
    rep = eng.cache_report()
    assert rep["reserved_bytes"] == rep["live_bytes"]
    assert eng.metrics.value("kv_cache_reserved_bytes") \
        == eng.metrics.value("kv_cache_live_bytes") == rep["live_bytes"]


def test_slab_bytes_checked_at_construction_and_report(ref):
    """The slab's bytes are computed once at construction, where the
    resident state is checked against the layout, as ``cache_report()``
    checks it again; the per-step gauges only read the stored sum."""
    eng = _engine(ref, max_seq=64, n_slots=2)
    rep = eng.cache_report()
    eng.state["k"]["extra"] = torch.zeros_like(eng.state["k"]["vals"])
    eng._sample_gauges()
    assert eng.metrics.value("kv_cache_reserved_bytes") \
        == rep["reserved_bytes"]
    with pytest.raises(RuntimeError, match="reserved"):
        eng.cache_report()


# ---------------------------------------------------------------------------
# page pool, pool growth, registries
# ---------------------------------------------------------------------------

def test_page_counters_balance_after_drain(obs_run):
    eng, trace, _ = obs_run
    m = eng.metrics
    mapped = m.value("page_pool_pages_mapped_total")
    freed = m.value("page_pool_pages_freed_total")
    assert mapped > 0
    assert mapped == freed, "drained pool must free every mapped page"
    assert len(trace.select("page_map")) == mapped
    assert sum(e["n_pages"] for e in trace.select("page_free")) == freed


def test_pool_grow_counter_and_event(ref):
    trace = EventTrace()
    eng = _engine(ref, max_seq=64, n_slots=2, paged=True, page_size=PAGE,
                  n_pages=2, pool_grow=True, trace=trace)
    eng.run(_mixed_trace(ref))
    grows = eng.metrics.value("page_pool_grows_total")
    assert grows >= 1
    evs = trace.select("pool_grow")
    assert len(evs) == grows
    assert all(e["pages_per_shard_new"] > e["pages_per_shard_old"]
               for e in evs)


def test_admission_holds_and_exhaustion_are_counted(ref):
    """A 30-token prompt maps 7 of the pool's 8 pages, so the second
    request waits for them (one hold per step); then an allocation past
    the pool is refused and counted."""
    trace = EventTrace()
    eng = _engine(ref, max_seq=64, n_slots=2, paged=True, page_size=4,
                  n_pages=9, trace=trace)
    eng.run([Request(uid="long", tokens=list(range(3, 33)), max_new_tokens=6),
             Request(uid="wait", tokens=list(range(5, 25)), max_new_tokens=6,
                     arrival_step=1)])
    holds = eng.metrics.value("serve_admission_holds_total")
    assert holds >= 1 and len(trace.select("admission_hold")) == holds
    assert {e["uid"] for e in trace.select("admission_hold")} == {"wait"}
    with pytest.raises(Exception, match="exhausted"):
        eng.pool.ensure(0, 64)
    assert eng.metrics.value("page_pool_exhausted_total") == 1
    (ev,) = trace.select("pool_exhausted")
    assert ev["slot"] == 0 and "exhausted" in ev["detail"]


def test_engine_registry_round_trips(obs_run):
    eng, _, _ = obs_run
    snap = eng.metrics.snapshot()
    assert MetricsRegistry.from_snapshot(snap).snapshot() == snap
    parsed = parse_prometheus(eng.metrics.to_prometheus())
    for name in eng.metrics.names():
        assert name in parsed["types"], f"{name} missing from exposition"


def test_shared_registry_across_engines(ref):
    reg = MetricsRegistry()
    for _ in range(2):
        eng = _engine(ref, max_seq=64, n_slots=2, metrics=reg)
        assert eng.metrics is reg
        eng.run(_mixed_trace(ref)[:2])
    assert reg.value("serve_requests_submitted_total") == 4


# ---------------------------------------------------------------------------
# captures: the port's "compiles", through the emulated graph set
# ---------------------------------------------------------------------------

def _compiles(m, phase):
    fam = m.snapshot()["metrics"].get("serve_compile_total", {"series": []})
    return sum(s["value"] for s in fam["series"]
               if s["labels"]["phase"] == phase)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_compile_counter_counts_captures(ref, layout):
    kw = dict(LAYOUTS[layout], max_seq=64, n_slots=2)
    trace = EventTrace()
    warm = _engine(ref, graphs=True, trace=trace, **kw)
    c0 = compile_events.total()
    rep = warm.warmup(max_prompt_len=32)
    assert compile_events.total() - c0 == rep["captures"] > 0
    assert _compiles(warm.metrics, "warmup") == rep["captures"]
    assert warm.metrics.value("serve_warmup_ms") == rep["warmup_ms"]
    (done,) = trace.select("warmup_done")
    assert done["compiles"] == rep["captures"]
    assert len(trace.select("warmup_start")) == 1
    warm.run(_mixed_trace(ref))
    assert _compiles(warm.metrics, "serve") == 0
    assert compile_events.total() - c0 == rep["captures"]
    # unwarmed: every capture happens mid-serve, counted per kind
    cold = _engine(ref, graphs=True, **kw)
    cold.run(_mixed_trace(ref))
    lazy = cold._graphs.lazy_captures
    assert _compiles(cold.metrics, "serve") == sum(lazy.values()) > 0
    for kind, n in lazy.items():
        assert cold.metrics.value("serve_compile_total", phase="serve",
                                  kind=kind) == n
    assert cold.metrics.get("serve_dispatch_ms", kind="decode",
                            kernel="torch").count == cold.dispatches["decode"]
