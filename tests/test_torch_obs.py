"""The port's observability primitives (``repro_torch.obs``) against the
reference's ``repro.obs``: the same operations on both registries give
equal snapshots, byte-equal Prometheus text, equal ``parse_prometheus``
readings and the same errors, and each side's snapshot rebuilds the other
side's registry exactly; the null registry absorbs everything; the event
trace writes the same JSONL; the step profiler brackets exactly N steps
(injected start/stop, and ``torch.profiler`` on the CPU); and
``compile_events`` counts exactly the graph captures of the emulated graph
set of ``tests/test_torch_warmup.py``."""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import metrics as j_metrics  # noqa: E402
from repro.obs import trace as j_trace  # noqa: E402
from repro_torch.obs import compile_events  # noqa: E402
from repro_torch.obs import metrics as t_metrics  # noqa: E402
from repro_torch.obs import trace as t_trace  # noqa: E402
pytest.register_assert_rewrite("test_torch_warmup")
from test_torch_warmup import EmulatedGraphs  # noqa: E402


def _try(log, fn):
    """Run ``fn``; log its result, or the type of the error it raised."""
    try:
        out = fn()
    except (ValueError, TypeError) as e:
        log.append(("raises", type(e).__name__))
        return
    log.append(("ok", repr(out)))


def _counters_gauges(m, log):
    reg = m.MetricsRegistry()
    c = reg.counter("reqs_total", "requests")
    c.inc()
    c.inc(3)
    _try(log, lambda: c.inc(-1))
    g = reg.gauge("depth", "queue depth")
    g.set(7)
    g.dec(2)
    g.inc()
    reg.gauge("ratio", "a float").set(0.1 + 0.2)
    reg.gauge("big", "a large value").set(3.5e12)
    reg.counter("frac_total", "fractional").inc(0.75)
    log += [reg.value("reqs_total"), reg.value("depth"),
            reg.value("nope", default=-1), reg.get("nope"), reg.names()]
    return reg


def _labels(m, log):
    reg = m.MetricsRegistry()
    reg.counter("dispatches", "by kind", kind="chunk").inc(2)
    reg.counter("dispatches", "by kind", kind="decode").inc(5)
    reg.gauge("shard_lanes", "by shard", shard=1).set(1)
    reg.gauge("shard_lanes", "by shard", shard=0).set(2)
    reg.histogram("ms", (0.5, 2.0), "two labels", kind="decode",
                  kernel="torch").observe(0.75)
    log += [reg.value("dispatches", kind="chunk"),
            reg.counter("dispatches", kind="chunk")
            is reg.counter("dispatches", kind="chunk")]
    return reg


def _histograms(m, log):
    reg = m.MetricsRegistry()
    h = reg.histogram("ttft", (1, 2, 4, 8), "steps")
    for v in (1, 1, 3, 5, 100):
        h.observe(v)
    log += [h.counts, h.sum, h.count, h.mean]
    log += [h.quantile(q) for q in (0.0, 0.4, 0.5, 0.99, 1.0)]
    _try(log, lambda: h.quantile(1.5))
    empty = reg.histogram("empty", (1,))
    log += [math.isnan(empty.quantile(0.5)), math.isnan(empty.mean)]
    lat = reg.histogram("lat", (0.05, 0.25, 2.5), "ms")
    for v in (0.01, 0.2, 0.3, 7.125):
        lat.observe(v)
    _try(log, lambda: reg.value("lat"))
    return reg


def _conflicts(m, log):
    reg = m.MetricsRegistry()
    reg.counter("x", "c")
    _try(log, lambda: reg.gauge("x"))
    reg.histogram("h", (1, 2, 4))
    _try(log, lambda: reg.histogram("h", (1, 2, 8)))
    _try(log, lambda: reg.histogram("bad", ()))
    _try(log, lambda: reg.histogram("bad", (4, 2, 1)))
    # a later registration may fill in a missing help text
    reg.counter("late_help")
    reg.counter("late_help", "filled in")
    return reg


def _populated(m, log):
    reg = m.MetricsRegistry()
    reg.counter("serve_requests_total", "submitted").inc(12)
    reg.counter("serve_dispatches_total", "by kind", kind="chunk").inc(4)
    reg.counter("serve_dispatches_total", "by kind", kind="decode").inc(9)
    reg.gauge("queue_depth", "pending").set(3)
    h = reg.histogram("ttft_steps", (1, 2, 4, 8), "ttft")
    for v in (1, 3, 3, 9):
        h.observe(v)
    reg._family("registered_but_empty", "counter", "no series yet", None)
    reg._family("empty_histogram", "histogram", "", (1, 2))
    return reg


SCRIPTS = {"counters_gauges": _counters_gauges, "labels": _labels,
           "histograms": _histograms, "conflicts": _conflicts,
           "populated": _populated}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_registry_matches_reference(name):
    j_log, t_log = [], []
    jreg = SCRIPTS[name](j_metrics, j_log)
    treg = SCRIPTS[name](t_metrics, t_log)
    assert repr(t_log) == repr(j_log)
    snap = jreg.snapshot()
    assert treg.snapshot() == snap
    assert treg.to_json(indent=2) == jreg.to_json(indent=2)
    text = jreg.to_prometheus()
    assert treg.to_prometheus() == text
    assert t_metrics.parse_prometheus(text) == j_metrics.parse_prometheus(text)
    # each side rebuilds the other's registry exactly
    assert t_metrics.MetricsRegistry.from_snapshot(snap).snapshot() == snap
    back = j_metrics.MetricsRegistry.from_snapshot(treg.snapshot())
    assert back.snapshot() == snap
    assert t_metrics.MetricsRegistry.from_snapshot(
        json.loads(treg.to_json())).to_prometheus() == text


def test_null_registry_is_inert():
    null = t_metrics.NullRegistry()
    assert isinstance(null, t_metrics.MetricsRegistry)
    assert not null.enabled and t_metrics.NULL_REGISTRY.enabled is False
    c = null.counter("x", "h", kind="a")
    c.inc(5)
    null.gauge("y").set(3)
    h = null.histogram("z", (1, 2))
    h.observe(9)
    assert math.isnan(h.quantile(0.5)) and math.isnan(h.mean)
    assert null.get("x") is None
    assert null.snapshot() == j_metrics.NullRegistry().snapshot() \
        == {"metrics": {}}
    assert null.to_prometheus() == j_metrics.NULL_REGISTRY.to_prometheus()
    assert c.value == 0 and h.count == 0 and h.counts == []


def _emit_events(tr):
    tr.emit("submit", step=0, uid="a", prompt_len=7, k=None)
    tr.emit("chunk_dispatch", step=1, lanes=2, slots=[0, 1], tokens=16)
    tr.emit("token", step=np.int64(2), uid="a", index=0, token=42)
    tr.emit("retire", step=5, uid="a", slot=0, reason="max_tokens")


def test_event_trace_matches_reference(tmp_path):
    paths = {}
    for tag, mod in (("ref", j_trace), ("port", t_trace)):
        paths[tag] = str(tmp_path / f"{tag}.jsonl")
        with mod.EventTrace(paths[tag]) as tr:
            _emit_events(tr)
            assert tr.events == []          # keep defaults to False with path
    text = open(paths["ref"]).read()
    assert open(paths["port"]).read() == text
    back = t_trace.EventTrace.read(paths["port"])
    assert back == j_trace.EventTrace.read(paths["ref"])
    assert back[2] == {"event": "token", "step": 2, "uid": "a", "index": 0,
                       "token": 42}
    mem, jmem = t_trace.EventTrace(), j_trace.EventTrace()
    _emit_events(mem)
    _emit_events(jmem)
    assert mem.events == jmem.events == back
    assert mem.select("token", uid="a") == jmem.select("token", uid="a")
    assert mem.select("nope") == []


def test_span_emits_wall_ms_and_none_is_noop():
    with t_trace.span(None, "nothing"):
        pass
    tr = t_trace.EventTrace()
    with t_trace.span(tr, "prefill", step=5, uid="r0"):
        pass
    (ev,) = tr.select("span")
    assert (ev["name"], ev["uid"], ev["step"]) == ("prefill", "r0", 5)
    assert ev["wall_ms"] >= 0.0


@pytest.mark.parametrize("n_steps", [1, 3])
def test_step_profiler_brackets_exactly_n_steps(n_steps):
    runs = {}
    for tag, mod in (("ref", j_trace), ("port", t_trace)):
        calls = []
        tr = mod.EventTrace()
        prof = mod.StepProfiler("/tmp/prof", n_steps, trace=tr,
                                start=lambda d, c=calls: c.append(("start", d)),
                                stop=lambda c=calls: c.append(("stop",)))
        for step in range(10):
            prof.step_start(step)
            calls.append(("step", step))
            prof.step_end(step + 1)
        assert prof.done and not prof.active
        runs[tag] = (calls, tr.events)
    assert runs["port"] == runs["ref"]
    calls = runs["port"][0]
    inside = calls[calls.index(("start", "/tmp/prof")) + 1:
                   calls.index(("stop",))]
    assert inside == [("step", s) for s in range(n_steps)]
    with pytest.raises(ValueError):
        t_trace.StepProfiler("/tmp/prof", 0)


def test_step_profiler_writes_a_torch_trace(tmp_path):
    tr = t_trace.EventTrace()
    prof = t_trace.StepProfiler(str(tmp_path / "prof"), 2, trace=tr)
    x = torch.ones(8, 8)
    for step in range(4):
        prof.step_start(step)
        x = torch.mm(x, x) / 8
        prof.step_end(step + 1)
    assert prof.done and prof.path.endswith("steps_0-2.pt.trace.json")
    events = json.load(open(prof.path))["traceEvents"]
    assert sum(e.get("name") == "aten::mm" for e in events) == 2
    assert [e["event"] for e in tr.events] == ["profile_start",
                                               "profile_stop"]


def test_compile_events_count_the_emulated_captures():
    compile_events.install()
    compile_events.install()                    # idempotent
    graphs = EmulatedGraphs(torch.device("cpu"))

    def fn(x):
        return x * 2

    c0 = compile_events.total()
    for key in (1, 2, 1, 3, 2, 1):
        graphs.run("decode", key, fn, [torch.ones(key)],
                   lambda key=key: [torch.zeros(key)])
    graphs.warming = True
    graphs.run("chunk", 4, fn, [torch.ones(4)], lambda: [torch.zeros(4)])
    graphs.warming = False
    assert compile_events.total() - c0 == sum(graphs.captures.values()) == 4
    assert graphs.replays["decode"] == 6
    assert sum(graphs.lazy_captures.values()) == 3
