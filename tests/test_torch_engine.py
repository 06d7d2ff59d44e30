"""The port's continuous-batching ``ServeEngine`` against the JAX
``ServeEngine`` on the float32 llama3-8b smoke config, with the reference's
weights and projections carried across: greedy tokens, engine steps,
dispatch counts and ``cache_report()`` identical on mixed-length, mixed-k
traces — slab and paged, monolithic and chunked (one and two prefill
lanes), an over-committed pool that grows, a request that never fits,
the dense-cache engine, ``srf`` admission, ``eos`` and ``arrival_step``.
Each reference run happens once per module (they dominate the time)."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import SwanConfig as JSwan  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch.io import make_batch as j_make_batch  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.runtime.page_pool import PagePoolExhausted as JExhausted  # noqa: E402
from repro.runtime.serve_engine import Request as JRequest  # noqa: E402
from repro.runtime.serve_engine import ServeEngine as JEngine  # noqa: E402
from repro.runtime.serve_loop import calibrate_swan as j_calibrate  # noqa: E402
from repro_torch.configs import SwanConfig, get_smoke_config  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.runtime.page_pool import PagePoolExhausted  # noqa: E402
from repro_torch.runtime.serve_engine import Request, ServeEngine  # noqa: E402

# straddle the chunk (8), page (16 / 8) and ring (4) boundaries
LENS = [3, 9, 17, 20, 12, 30, 5]
K_CYCLE = [None, 4, 6]                  # per-request k (k_max = 8)
EOS = 2                                 # request index that stops on eos

CONFIGS = {
    "slab_monolithic": dict(),
    "slab_chunked_1_srf_eos_arrivals": dict(prefill_chunk=8,
                                            admission="srf"),
    "slab_chunked_2": dict(prefill_chunk=8, prefill_slots=2),
    "paged_monolithic": dict(paged=True, page_size=16),
    "paged_chunked_1": dict(paged=True, page_size=16, prefill_chunk=8),
    "paged_chunked_2_pool_grow": dict(paged=True, page_size=16, n_pages=2,
                                      pool_grow=True, prefill_chunk=8,
                                      prefill_slots=2),
    "dense_chunked_2_srf": dict(prefill_chunk=8, prefill_slots=2,
                                admission="srf"),
    # no ring: every chunk token is winnowed at once (``swan`` overrides
    # the SwanConfig fields that ``_engine`` sets)
    "slab_chunked_2_buffer0": dict(prefill_chunk=8, prefill_slots=2,
                                   swan=dict(buffer=0)),
    "paged_chunked_2_buffer0": dict(paged=True, page_size=16,
                                    prefill_chunk=8, prefill_slots=2,
                                    swan=dict(buffer=0)),
}


@pytest.fixture(scope="module")
def ref():
    """The reference's f32 smoke pipeline, its tensors in torch, and a
    per-config cache of its engine runs."""
    jcfg = j_smoke("llama3-8b").replace(dtype="float32", param_dtype="float32")
    tcfg = get_smoke_config("llama3-8b").replace(dtype="float32",
                                                 param_dtype="float32")
    japi = j_get_model(jcfg)
    params = japi.init_params(jax.random.PRNGKey(0), jcfg)
    pj = j_calibrate(japi, jcfg, params, j_make_batch(jcfg, 2, 24, seed=3))
    absorbed = japi.absorb(params, jcfg, pj)
    prompts = [np.asarray(j_make_batch(jcfg, 1, n, seed=40 + i)["tokens"][0]
                          ).tolist() for i, n in enumerate(LENS)]
    t = {n: to_torch(x, device="cpu") for n, x in
         (("params", params), ("absorbed", absorbed), ("pj", pj))}
    return {"jcfg": jcfg, "tcfg": tcfg, "params": params,
            "absorbed": absorbed, "pj": pj, "t": t, "prompts": prompts,
            "runs": {}}


def _requests(cls, prompts, name, eos=None):
    arrivals = "arrivals" in name
    return [cls(uid=f"r{i}", tokens=p, max_new_tokens=6,
                k=None if name.startswith("dense") else K_CYCLE[i % 3],
                eos=eos if i == EOS else None,
                arrival_step=2 * i if arrivals else 0)
            for i, p in enumerate(prompts)]


def _engine(cls, swan_cls, cfg, weights, name, **extra):
    kw = dict(CONFIGS[name])
    dense = name.startswith("dense")
    swan = None if dense else swan_cls(**{"k_max": 8, "buffer": 4,
                                          **kw.pop("swan", {})})
    return cls(cfg, weights["params" if dense else "absorbed"], swan=swan,
               projections=None if dense else weights["pj"], max_seq=64,
               n_slots=2, **kw, **extra)


def _summary(eng, comps):
    return ({c.uid: (c.tokens, c.admitted_step, c.first_token_step,
                     c.finished_step) for c in comps},
            eng.step_count, eng.dispatches, eng.cache_report())


def _reference_run(ref, name):
    if name not in ref["runs"]:
        eos = None
        if "eos" in name:
            # a request's tokens do not depend on the schedule: stop request
            # EOS at the 2nd token it generates in another chunked run
            toks = _reference_run(ref, "slab_chunked_2")[1][0][f"r{EOS}"][0]
            eos = toks[1]
        eng = _engine(JEngine, JSwan, ref["jcfg"], ref, name)
        comps = eng.run(_requests(JRequest, ref["prompts"], name, eos))
        ref["runs"][name] = (eos, _summary(eng, comps))
    return ref["runs"][name]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_engine_matches_reference(ref, name):
    eos, want = _reference_run(ref, name)
    eng = _engine(ServeEngine, SwanConfig, ref["tcfg"], ref["t"], name,
                  device="cpu")
    comps = eng.run(_requests(Request, ref["prompts"], name, eos))
    got = _summary(eng, comps)
    assert got[0] == want[0]                  # tokens and step stamps
    assert got[1:3] == want[1:3]              # engine steps, dispatches
    assert got[3] == want[3]                  # cache_report
    if eos is not None:                       # stopped on eos
        toks = got[0][f"r{EOS}"][0]
        assert toks[-1] == eos and len(toks) <= 2
    if "pool_grow" in name:
        assert eng.pool.n_pages > CONFIGS[name]["n_pages"]
        eng.pool.check_consistent()


def test_paged_engine_equals_slab_engine(ref):
    """Within the port: the paged engine gives the slab engine's tokens
    and its live bytes drop to the rings once every request retired."""
    slab = _engine(ServeEngine, SwanConfig, ref["tcfg"], ref["t"],
                   "slab_chunked_2", device="cpu")
    paged = _engine(ServeEngine, SwanConfig, ref["tcfg"], ref["t"],
                    "paged_chunked_1", device="cpu", prefill_slots=2)
    reqs = lambda: _requests(Request, ref["prompts"], "x")  # noqa: E731
    want = {c.uid: c.tokens for c in slab.run(reqs())}
    assert {c.uid: c.tokens for c in paged.run(reqs())} == want
    rep = paged.cache_report()
    assert rep["live_pages"] == 0
    assert rep["live_bytes"] < slab.cache_report()["reserved_bytes"]


def test_never_fitting_request_fails_fast(ref):
    # 30 + 30 tokens need 4 pages of 16 over their lifetime; the pool has 3
    req = dict(uid="big", tokens=ref["prompts"][5], max_new_tokens=30)
    with pytest.raises(JExhausted, match="lifetime"):
        _engine(JEngine, JSwan, ref["jcfg"], ref, "paged_monolithic",
                n_pages=4).run([JRequest(**req)])
    with pytest.raises(PagePoolExhausted, match="lifetime"):
        _engine(ServeEngine, SwanConfig, ref["tcfg"], ref["t"],
                "paged_monolithic", n_pages=4, device="cpu"
                ).run([Request(**req)])


def test_constructor_checks_match_reference(ref):
    bad = [dict(prefill_chunk=6), dict(prefill_slots=2),
           dict(prefill_budget=8), dict(admission="lifo"),
           dict(paged=True, page_size=24)]
    for kw in bad:
        with pytest.raises(ValueError):
            JEngine(ref["jcfg"], ref["absorbed"], swan=JSwan(k_max=8, buffer=4),
                    projections=ref["pj"], max_seq=64, n_slots=2, **kw)
        with pytest.raises(ValueError):
            ServeEngine(ref["tcfg"], ref["t"]["absorbed"],
                        swan=SwanConfig(k_max=8, buffer=4),
                        projections=ref["t"]["pj"], max_seq=64, n_slots=2,
                        device="cpu", **kw)
    with pytest.raises(ValueError, match="requires SWAN"):
        ServeEngine(ref["tcfg"], ref["t"]["params"], max_seq=64, n_slots=2,
                    paged=True, device="cpu")


def test_engine_defaults_to_the_card(ref):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(ref["tcfg"], ref["t"]["params"], max_seq=64, n_slots=2)


def test_engine_launcher_runs_on_cpu(capsys):
    serve_cli.main(["--arch", "llama3-8b", "--smoke", "--swan", "--k", "8",
                    "--buffer", "8", "--tokens", "4", "--batch", "2",
                    "--prompt-len", "20", "--max-seq", "128", "--device",
                    "cpu", "--engine", "--requests", "3", "--mixed-k",
                    "--paged", "--page-size", "16", "--prefill-chunk", "16",
                    "--prefill-slots", "2"])
    out = capsys.readouterr().out
    assert "engine: 3 requests, 12 tokens" in out
    assert "'chunk': " in out and "paged: reserved" in out


@pytest.mark.parametrize("argv", [
    ["--prefill-chunk", "16"],                       # needs --engine
    ["--engine", "--prefill-slots", "2"],           # needs --prefill-chunk
    ["--engine", "--paged"],                         # needs --swan
    ["--engine", "--swan", "--pool-grow"],           # needs --paged
])
def test_engine_launcher_flag_checks(argv):
    with pytest.raises(SystemExit):
        serve_cli.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                        *argv])
