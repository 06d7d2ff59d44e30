"""The port's launcher flags and serve benchmarks that read the metrics,
on the CPU at smoke size: ``--metrics-out`` (Prometheus text and JSON),
``--trace-out`` and ``--profile-steps`` write files that parse, with the
reference's refusals; ``bench_serve_engine`` and ``bench_paged_cache``
pass their gates with ``--smoke --device cpu``; ``bench_warmup`` passes
its gates through the emulated graph set of ``tests/test_torch_warmup.py``
patched over ``GraphSet``, and raises on the CPU without it."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import (bench_paged_cache,  # noqa: E402
                                    bench_serve_engine, bench_warmup)
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.obs import EventTrace, parse_prometheus  # noqa: E402
from repro_torch.runtime import serve_engine  # noqa: E402
pytest.register_assert_rewrite("test_torch_warmup")
from test_torch_warmup import EmulatedGraphs  # noqa: E402

BASE = ["--arch", "llama3-8b", "--smoke", "--swan", "--k", "8", "--buffer",
        "8", "--tokens", "4", "--batch", "2", "--prompt-len", "20",
        "--max-seq", "128", "--device", "cpu"]
ENGINE = ["--engine", "--requests", "3", "--paged", "--page-size", "16",
          "--prefill-chunk", "16", "--prefill-slots", "2"]


@pytest.mark.parametrize("suffix", [".prom", ".json"])
def test_launcher_writes_metrics_trace_and_profile(tmp_path, capsys, suffix):
    metrics = tmp_path / f"metrics{suffix}"
    trace = tmp_path / "trace.jsonl"
    prof = tmp_path / "prof"
    serve_cli.main(BASE + ENGINE + [
        "--metrics-out", str(metrics), "--trace-out", str(trace),
        "--profile-steps", "2", "--profile-dir", str(prof)])
    out = capsys.readouterr().out
    assert "engine: 3 requests, 12 tokens" in out and "ttft: p50" in out
    text = metrics.read_text()
    if suffix == ".prom":
        samples = parse_prometheus(text)["samples"]
        assert samples[("serve_tokens_generated_total", ())] == 12
        assert samples[("serve_dispatches_total", (("kind", "chunk"),))] > 0
    else:
        fams = json.loads(text)["metrics"]
        assert fams["serve_tokens_generated_total"]["series"][0]["value"] == 12
        assert fams["serve_ttft_steps"]["series"][0]["count"] == 3
    events = EventTrace.read(str(trace))
    assert sum(e["event"] == "first_token" for e in events) == 3
    assert sum(e["event"] == "retire" for e in events) == 3
    start = [e for e in events if e["event"] == "profile_start"]
    stop = [e for e in events if e["event"] == "profile_stop"]
    assert [e["step"] for e in start + stop] == [0, 2]
    (path,) = prof.glob("steps_0-2.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "aten::mm" in names or "aten::matmul" in names


def test_lockstep_launcher_writes_session_metrics(tmp_path):
    metrics = tmp_path / "session.prom"
    serve_cli.main(BASE + ["--metrics-out", str(metrics)])
    samples = parse_prometheus(metrics.read_text())["samples"]
    assert samples[("session_prefill_total", ())] == 1
    assert samples[("session_decode_total", ())] == 3
    assert samples[("session_tokens_generated_total", ())] == 8


@pytest.mark.parametrize("argv", [
    ["--trace-out", "t.jsonl"],                      # needs --engine
    ["--profile-steps", "2"],                        # needs --engine
])
def test_launcher_obs_flag_checks(argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="require --engine"):
        serve_cli.main(BASE + argv)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("bench", [bench_serve_engine, bench_paged_cache],
                         ids=["serve_engine", "paged_cache"])
def test_serve_bench_gates_pass_on_cpu(bench, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path))
    bench.run(smoke=True, device="cpu")
    (path,) = tmp_path.glob("BENCH_*_torch.json")
    out = json.loads(path.read_text())
    assert out["ok"] is True and out["device"] == "cpu"
    assert out["gates"] and all(g["passed"] for g in out["gates"])
    assert out["extra"]["metrics"]
    for snap in out["extra"]["metrics"].values():
        assert snap["metrics"]["serve_tokens_generated_total"]["series"]


class _CardClock:
    """A virtual clock for ``bench_warmup``, advanced by the emulated graph
    set as the card's would be: a capture costs a hundred replays
    (hundreds of ms against ms on the card).  The bench's wall-clock TTFT
    gate then reads the same ratio on any host, where a shared CPU's noise
    would swamp the emulation's own host time."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


def _costed_graphs(clock):
    class CostedGraphs(EmulatedGraphs):
        def _record(self, fn, inputs):
            clock.t += 0.5
            return super()._record(fn, inputs)

        def run(self, *a, **kw):
            clock.t += 0.005
            return super().run(*a, **kw)
    return CostedGraphs


def test_warmup_bench_gates_pass_under_emulated_graphs(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path))
    clock = _CardClock()
    monkeypatch.setattr(serve_engine, "GraphSet", _costed_graphs(clock))
    monkeypatch.setattr(bench_warmup, "time", clock)
    bench_warmup.run(smoke=True, device="cpu")
    out = json.loads((tmp_path / "BENCH_warmup_torch.json").read_text())
    assert out["ok"] is True
    assert [g["name"] for g in out["gates"]] == [
        "warmup_idempotent_slab", "warm_ttft_le_half_cold",
        "zero_steady_state_compiles_slab", "warmup_idempotent_paged",
        "zero_steady_state_compiles_paged", "async_token_identity",
        "async_dispatch_counts", "async_matches_warmed"]
    snap = out["extra"]["metrics"]["slab"]["metrics"]
    warm = [s for s in snap["serve_compile_total"]["series"]
            if s["labels"]["phase"] == "warmup"]
    assert warm and not [s for s in snap["serve_compile_total"]["series"]
                         if s["labels"]["phase"] == "serve"]


def test_warmup_bench_raises_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_warmup.run(smoke=True, device="cpu")
