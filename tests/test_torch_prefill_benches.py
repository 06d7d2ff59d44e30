"""The port's chunked- and concurrent-prefill benches at ``--smoke --device
cpu`` on the reference benches' own model (the reference's weights and
projections carried across): every gate passes, and the tokens and TTFT
steps equal the reference ``ServeEngine``'s on the same trace.  The
chunked bench's wall-clock gates read a virtual clock that each model
dispatch advances by the tokens it processes, as the card's time follows
them: a loaded CPU runner's noise cannot fail them."""
import dataclasses
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import SwanConfig as JSwan  # noqa: E402
from repro.launch.io import make_batch as j_make_batch  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.runtime.serve_engine import ServeEngine as JEngine  # noqa: E402
from repro.runtime.serve_loop import calibrate_swan as j_calibrate  # noqa: E402
from repro_torch.benchmarks import bench_chunked_prefill as chunked  # noqa: E402
from repro_torch.benchmarks import bench_concurrent_prefill as concurrent  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.runtime import serve_engine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(dtype="float32", param_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_bench(name):
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import importlib
    return importlib.import_module(f"benchmarks.bench_{name}")


@pytest.fixture(scope="module")
def ref():
    """The reference benches' model (their ``_cfg()``, seed, calibration)
    and its tensors in torch, as ``(cfg, params, projections, absorbed)``."""
    jcfg = _ref_bench("chunked_prefill")._cfg()
    japi = j_get_model(jcfg)
    params = japi.init_params(jax.random.PRNGKey(0), jcfg)
    pj = j_calibrate(japi, jcfg, params, j_make_batch(jcfg, 2, 32, seed=3))
    absorbed = japi.absorb(params, jcfg, pj)
    tcfg = get_smoke_config("llama3-8b").replace(**F32)
    assert all(getattr(tcfg, f.name) == getattr(jcfg, f.name)
               for f in dataclasses.fields(tcfg))
    t = to_torch({"params": params, "pj": pj, "absorbed": absorbed},
                 device="cpu")
    return {"jcfg": jcfg, "absorbed": absorbed, "pj": pj,
            "model": (tcfg, t["params"], t["pj"], t["absorbed"])}


class _CardClock:
    """Virtual time: a dispatch costs 1 ms plus 50 µs per token it
    processes (prompt, chunk or decode lane)."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


def _costed_model(clock):
    real = registry.get_model

    def get_model(cfg):
        api = real(cfg)

        def costed(fn, n_tokens):
            def call(p, cfg_, batch_or_tok, *a, **kw):
                clock.t += 1e-3 + 5e-5 * n_tokens(batch_or_tok)
                return fn(p, cfg_, batch_or_tok, *a, **kw)
            return call
        toks = lambda b: b["tokens"].numel()  # noqa: E731
        return dataclasses.replace(
            api, prefill=costed(api.prefill, toks),
            prefill_chunk=costed(api.prefill_chunk, toks),
            decode_step=costed(api.decode_step, lambda t: t.shape[0]))
    return get_model


def _reference_tokens(ref, bench, sz, **engine_kw):
    """The reference engine over the reference bench's trace: tokens and
    TTFT steps by request."""
    reqs = bench._trace(ref["jcfg"], sz.n_requests, sz.gen_tokens,
                        sz.long_len)
    eng = JEngine(ref["jcfg"], ref["absorbed"],
                  swan=JSwan(k_max=ref["jcfg"].d_head, buffer=sz.buffer,
                             mode="topk"),
                  projections=ref["pj"], max_seq=sz.max_seq,
                  n_slots=bench.N_SLOTS, prefill_chunk=sz.chunk, **engine_kw)
    comps = {c.uid: c for c in eng.run(reqs)}
    return ({u: c.tokens for u, c in comps.items()},
            {r.uid: comps[r.uid].first_token_step - r.arrival_step
             for r in reqs})


def _gates(tmp_path, name):
    out = json.loads((tmp_path / f"BENCH_{name}_torch.json").read_text())
    assert out["ok"] is True and out["device"] == "cpu"
    return {g["name"]: g["passed"] for g in out["gates"]}


def test_chunked_prefill_bench(ref, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path))
    clock = _CardClock()
    monkeypatch.setattr(chunked, "time", clock)
    monkeypatch.setattr(serve_engine, "get_model", _costed_model(clock))
    stats, tokens = chunked.run(smoke=True, device="cpu", model=ref["model"])
    assert _gates(tmp_path, "chunked_prefill") == {
        "token_identity": True, "p99_improves": True,
        "worst_step_improves": True, "prefill_execs_log_bound": True}
    sz = chunked.sizes(True)
    assert sz.max_seq == 512 and sz.chunk == 16 and sz.buffer == 8
    jbench = _ref_bench("chunked_prefill")
    want, _ = _reference_tokens(ref, jbench, sz)
    assert tokens["monolithic"] == tokens["chunked"] == want
    assert stats["chunked"]["steps"] > stats["monolithic"]["steps"]


def test_concurrent_prefill_bench(ref, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path))
    stats, tokens, ttfts = concurrent.run(smoke=True, device="cpu",
                                          model=ref["model"])
    assert _gates(tmp_path, "concurrent_prefill") == {
        "ttft_metric_matches": True, "token_identity": True,
        "ttft_p99": True, "no_extra_steps": True,
        "prefill_execs_bound": True}
    jbench = _ref_bench("concurrent_prefill")
    sz = concurrent.sizes(True)
    for mode, p_slots in (("serial", 1), ("batched", jbench.N_SLOTS)):
        want_tokens, want_ttft = _reference_tokens(ref, jbench, sz,
                                                   prefill_slots=p_slots)
        assert tokens[mode] == want_tokens
        assert ttfts[mode] == want_ttft
    assert stats["serial"]["ttft_p99"] == pytest.approx(
        np.percentile(list(ttfts["serial"].values()), 99))
