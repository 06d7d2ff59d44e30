"""The port's mesh-sharded ``ServeEngine`` against the reference's.

The reference shards its engine over 8 simulated host devices, which exist
only in a process that sets ``XLA_FLAGS=--xla_force_host_platform_device_
count=8`` before importing jax: one module-scoped subprocess runs the
slab, paged and pool-growth engines on ``tests/test_sharded_engine.py``'s
trace over ``make_serve_mesh(8)`` (mixed prompt lengths, mixed per-request
k, a temperature lane, staggered arrivals, concurrent chunked prefill,
2 slots per shard), plus ``_sparse_stats_sharded`` on a ``(2, 4)``
``('data', 'model')`` mesh, and pickles what it saw.  The port runs the
same in process over ``make_serve_mesh(8, devices=["cpu"] * 8)`` with the
reference's weights and is held to it exactly: tokens, per-step dispatch
counts, every step's shard-local page table and per-shard free pages,
per-shard cache reports, first-token steps; the split-S stats at 5e-5
(float32).  The temperature lane is held on the logits rows it samples
from (torch cannot reproduce ``jax.random``): both engines record the
row and feed its argmax.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SwanConfig, get_smoke_config  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core import swan_attention as swa  # noqa: E402
from repro_torch.launch.mesh import (make_mesh, make_production_mesh,  # noqa: E402
                                     make_serve_mesh)
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.obs import EventTrace  # noqa: E402
from repro_torch.runtime.serve_engine import Request, ServeEngine  # noqa: E402
from repro_torch.runtime.warmup import executable_family  # noqa: E402
from repro_torch.sharding.api import P, ShardingRules, use_rules  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
DIMS = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
            d_ff=128, dtype="float32", param_dtype="float32")
# (prompt len, new tokens, k, temperature, arrival step): the reference
# test's trace
SPEC = [(6, 6, 8, 0.0, 0), (11, 5, 4, 0.0, 0), (17, 7, None, 0.0, 1),
        (9, 6, 2, 0.8, 2), (21, 4, 8, 0.0, 3), (7, 5, 4, 0.0, 4),
        (13, 6, None, 0.0, 4), (5, 4, 8, 0.0, 6)]
# engine kwargs per run, as the reference test's (n_slots 16 over dp 8:
# 2 slots per shard; the growth run 8 over 8, a 2-page shard)
RUNS = {
    "slab": dict(max_seq=64, n_slots=16, prefill_chunk=8, prefill_slots=4),
    "paged": dict(max_seq=64, n_slots=16, prefill_chunk=8, prefill_slots=4,
                  paged=True, page_size=8),
    "grow": dict(max_seq=64, n_slots=8, prefill_chunk=8, prefill_slots=2,
                 paged=True, page_size=8, n_pages=16, pool_grow=True),
}
# held to the port's one-shard engine only: monolithic admission on pages
# (each insert lands on its owner's block of the pool)
MONOLITHIC = dict(max_seq=64, n_slots=8, paged=True, page_size=8)
# split-S stats inputs: B, Kv, G, dh, S, k
STATS = (4, 2, 2, 16, 32, 8)

_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import pickle
import sys
sys.path.insert(0, "src")
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import SwanConfig, get_smoke_config
from repro.core import swan_attention as swa
from repro.launch.io import make_batch
from repro.launch.mesh import make_mesh, make_serve_mesh
from repro.models import get_model
from repro.obs import EventTrace
from repro.runtime.serve_engine import Request, ServeEngine
from repro.runtime.serve_loop import calibrate_swan
from repro.runtime.warmup import executable_family

out_path, DIMS, SPEC, RUNS, STATS = pickle.loads(bytes.fromhex(sys.argv[1]))
cfg = get_smoke_config("llama3-8b").replace(**DIMS)
api = get_model(cfg)
params = api.init_params(jax.random.PRNGKey(0), cfg)
pj = calibrate_swan(api, cfg, params, make_batch(cfg, 2, 24, seed=3))
absorbed = api.absorb(params, cfg, pj)
swan = SwanConfig(k_max=8, buffer=4, mode="topk")
mesh = make_serve_mesh(8)
assert jax.device_count() == 8
prompts = [[int(t) for t in make_batch(cfg, 1, n, seed=20 + i)["tokens"][0]]
           for i, (n, *_) in enumerate(SPEC)]


def record_rows(eng, rows):
    orig = eng._sample

    def sample(logits, req, n_prev):
        if req.temperature <= 0.0:
            return orig(logits, req, n_prev)
        row = np.array(logits, np.float32)
        rows[(req.uid, n_prev)] = row
        return int(np.argmax(row))
    eng._sample = sample


def drain(eng):
    rows = {}
    record_rows(eng, rows)
    for i, (n, g, k, t, a) in enumerate(SPEC):
        eng.submit(Request(uid=f"m{i}", tokens=prompts[i], max_new_tokens=g,
                           k=k, temperature=t, seed=7 + i, arrival_step=a))
    steps = []
    while not eng.done:
        before = dict(eng.dispatches)
        eng.step()
        rec = {"dispatches": {k: eng.dispatches[k] - before[k]
                              for k in eng.dispatches},
               "shards": eng.cache_report()["shards"]}
        if eng.paged:
            rec["table"] = eng.pool.table.copy()
            rec["free"] = [eng.pool.shard_free_pages(s)
                           for s in range(eng.dp)]
            rec["pages_per_shard"] = eng.pool.pages_per_shard
        steps.append(rec)
    rep = eng.cache_report()
    return {"completions": {c.uid: (c.tokens, c.admitted_step,
                                    c.first_token_step, c.finished_step)
                            for c in eng.completions},
            "steps": steps, "rows": rows, "step_count": eng.step_count,
            "dispatches": dict(eng.dispatches), "dp": eng.dp,
            "n_local": eng.n_local,
            "report": {k: rep[k] for k in ("reserved_bytes", "live_bytes",
                                           "shards")},
            "family": [(i.kind, i.page_bucket, i.n_lanes, i.chunk, i.prefix,
                        i.pad_len, i.width, i.src, i.detail)
                       for i in executable_family(eng)["items"]],
            "expected": executable_family(eng)["expected"]}


out = {"runs": {}}
for name, kw in RUNS.items():
    tr = EventTrace()
    eng = ServeEngine(cfg, absorbed, swan=swan, projections=pj, mesh=mesh,
                      trace=tr, **kw)
    res = drain(eng)
    if eng.paged:
        eng.pool.check_consistent()
    res["first_token_events"] = {
        uid: [e["step"] for e in tr.select("first_token", uid=uid)]
        for uid in res["completions"]}
    res["ttft_count"] = eng.metrics.get("serve_ttft_steps").count
    out["runs"][name] = res

B, Kv, G, dh, S, k = STATS
rng = np.random.RandomState(0)
q = rng.randn(B, Kv, G, dh).astype(np.float32)
side = lambda: {"vals": rng.randn(B, Kv, S, k).astype(np.float32),
                "idx": np.sort(np.argsort(rng.rand(B, Kv, S, dh), -1)[..., :k],
                               -1).astype(np.int8)}
cache = {"k": side(), "v": side()}
sp_len = np.array([0, 5, 17, 32], np.int32)
m, l, o = swa._sparse_stats_sharded(
    jnp.asarray(q), jax.tree_util.tree_map(jnp.asarray, cache), swan,
    jnp.asarray(sp_len), make_mesh((2, 4), ("data", "model")), "model")
out["stats"] = {"q": q, "cache": cache, "sp_len": sp_len,
                "m": np.asarray(m), "l": np.asarray(l), "o": np.asarray(o)}
to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
out["weights"] = {"absorbed": to_np(absorbed), "pj": to_np(pj)}
out["prompts"] = prompts
with open(out_path, "wb") as fh:
    pickle.dump(out, fh)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded") / "ref.pkl"
    arg = pickle.dumps((str(path), DIMS, SPEC, RUNS, STATS)).hex()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _SCRIPT, arg],
                         capture_output=True, text=True, timeout=900,
                         cwd=str(REPO), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(path, "rb") as fh:
        rec = pickle.load(fh)
    rec["t"] = {n: to_torch(x, device="cpu")
                for n, x in rec["weights"].items()}
    rec["port"] = {}
    return rec


def _cfg():
    return get_smoke_config("llama3-8b").replace(**DIMS)


def _engine(ref, name, mesh=None, **kw):
    return ServeEngine(_cfg(), ref["t"]["absorbed"],
                       swan=SwanConfig(k_max=8, buffer=4, mode="topk"),
                       projections=ref["t"]["pj"], mesh=mesh, device="cpu",
                       **{**RUNS.get(name, {}), **kw})


def _drain(ref, eng):
    """The subprocess's ``drain`` on the port's engine."""
    rows = {}
    orig = eng._sample

    def sample(logits, req, n_prev):
        if req.temperature <= 0.0:
            return orig(logits, req, n_prev)
        row = np.array(logits, np.float32)
        rows[(req.uid, n_prev)] = row
        return int(np.argmax(row))
    eng._sample = sample
    for i, (n, g, k, t, a) in enumerate(SPEC):
        eng.submit(Request(uid=f"m{i}", tokens=ref["prompts"][i],
                           max_new_tokens=g, k=k, temperature=t, seed=7 + i,
                           arrival_step=a))
    steps = []
    while not eng.done:
        before = dict(eng.dispatches)
        eng.step()
        rec = {"dispatches": {k: eng.dispatches[k] - before[k]
                              for k in eng.dispatches},
               "shards": eng.cache_report()["shards"]}
        if eng.paged:
            rec["table"] = eng.pool.table.copy()
            rec["free"] = [eng.pool.shard_free_pages(s)
                           for s in range(eng.dp)]
            rec["pages_per_shard"] = eng.pool.pages_per_shard
        steps.append(rec)
    rep = eng.cache_report()
    fam = executable_family(eng)
    return {"completions": {c.uid: (c.tokens, c.admitted_step,
                                    c.first_token_step, c.finished_step)
                            for c in eng.completions},
            "steps": steps, "rows": rows, "step_count": eng.step_count,
            "dispatches": dict(eng.dispatches), "dp": eng.dp,
            "n_local": eng.n_local,
            "report": {k: rep[k] for k in ("reserved_bytes", "live_bytes",
                                           "shards")},
            "family": [(i.kind, i.page_bucket, i.n_lanes, i.chunk, i.prefix,
                        i.pad_len, i.width, i.src, i.detail)
                       for i in fam["items"]],
            "expected": fam["expected"]}


def _port(ref, name):
    if name not in ref["port"]:
        tr = EventTrace()
        eng = _engine(ref, name, mesh=make_serve_mesh(8, ["cpu"] * 8),
                      trace=tr)
        res = _drain(ref, eng)
        if eng.paged:
            eng.pool.check_consistent()
        res["first_token_events"] = {
            uid: [e["step"] for e in tr.select("first_token", uid=uid)]
            for uid in res["completions"]}
        res["ttft_count"] = eng.metrics.get("serve_ttft_steps").count
        res["engine"] = eng
        ref["port"][name] = res
    return ref["port"][name]


@pytest.mark.parametrize("name", list(RUNS))
def test_tokens_and_steps_match_the_reference(ref, name):
    """Tokens, admission / first-token / finish steps, engine steps and
    dispatch totals equal the reference's 8-device engine."""
    want, got = ref["runs"][name], _port(ref, name)
    assert got["dp"] == want["dp"] == 8
    assert got["n_local"] == want["n_local"]
    assert got["completions"] == want["completions"]
    assert got["step_count"] == want["step_count"]
    assert got["dispatches"] == want["dispatches"]


@pytest.mark.parametrize("name", list(RUNS))
def test_temperature_lane_logits_match(ref, name):
    want, got = ref["runs"][name]["rows"], _port(ref, name)["rows"]
    assert want and sorted(got) == sorted(want)
    for key, row in want.items():
        np.testing.assert_allclose(got[key], row, atol=5e-5)


@pytest.mark.parametrize("name", list(RUNS))
def test_per_step_dispatches_match_and_stay_one_each(ref, name):
    """One chunk and one decode dispatch at most per step, whatever the
    shard count, step for step as the reference's."""
    want, got = ref["runs"][name]["steps"], _port(ref, name)["steps"]
    assert [s["dispatches"] for s in got] == [s["dispatches"] for s in want]
    assert max(s["dispatches"]["chunk"] for s in got) <= 1
    assert max(s["dispatches"]["decode"] for s in got) <= 1


@pytest.mark.parametrize("name", ["paged", "grow"])
def test_shard_local_page_tables_match_every_step(ref, name):
    want, got = ref["runs"][name]["steps"], _port(ref, name)["steps"]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g["table"], w["table"]), f"step {i}"
        assert g["free"] == w["free"], f"step {i}"
        assert g["pages_per_shard"] == w["pages_per_shard"], f"step {i}"
    if name == "grow":
        assert got[-1]["pages_per_shard"] > 2


@pytest.mark.parametrize("name", list(RUNS))
def test_per_shard_cache_reports_match_and_sum(ref, name):
    want, got = ref["runs"][name], _port(ref, name)
    for g, w in zip(got["steps"], want["steps"]):
        assert g["shards"] == w["shards"]
    rep = got["report"]
    assert rep == want["report"]
    assert len(rep["shards"]) == 8
    for key in ("reserved_bytes", "live_bytes"):
        assert sum(s[key] for s in rep["shards"]) == rep[key]
    eng = got["engine"]
    if eng.paged:
        assert sum(s["page_table_shipped_bytes"] for s in rep["shards"]) \
            == eng.page_table_shipped_bytes()
        assert eng.pool.live_pages == 0


@pytest.mark.parametrize("name", list(RUNS))
def test_first_token_recorded_once(ref, name):
    want, got = ref["runs"][name], _port(ref, name)
    assert got["first_token_events"] == want["first_token_events"]
    assert all(len(v) == 1 for v in got["first_token_events"].values())
    assert got["ttft_count"] == want["ttft_count"] == len(SPEC)


@pytest.mark.parametrize("name", list(RUNS))
def test_executable_family_under_the_mesh_matches(ref, name):
    """The warmup family of a dp = 8 engine: chunk lanes dp x each
    per-shard bucket, the reference's items, details and counts."""
    want, got = ref["runs"][name], _port(ref, name)
    assert got["family"] == want["family"]
    assert got["expected"] == want["expected"]


def test_sharded_equals_one_shard_in_the_port(ref):
    """The port's dp = 8 engine gives its dp = 1 engine's tokens on every
    layout (the steps differ: each shard has its own prefill budget),
    monolithic admission on pages and the dense cache too."""
    def tokens(run):
        return {u: c[0] for u, c in run["completions"].items()}
    for name in RUNS:
        one = _drain(ref, _engine(ref, name))
        assert tokens(one) == tokens(_port(ref, name))
    mesh = make_serve_mesh(8, ["cpu"] * 8)
    one = _drain(ref, _engine(ref, None, **MONOLITHIC))
    eng = _engine(ref, None, mesh=mesh, **MONOLITHIC)
    got = _drain(ref, eng)
    assert tokens(got) == tokens(one)
    eng.pool.check_consistent()
    assert eng.pool.live_pages == 0 and got["steps"][-1]["free"] == [
        eng.pool.pages_per_shard - 1] * 8
    cfg = _cfg()
    api = get_model(cfg)
    params = api.init_params(cfg, 0, "cpu")
    kw = dict(max_seq=64, n_slots=16, prefill_chunk=8, prefill_slots=4,
              device="cpu")
    reqs = lambda: [Request(uid=f"d{i}", tokens=ref["prompts"][i],  # noqa
                            max_new_tokens=g, arrival_step=a)
                    for i, (n, g, k, t, a) in enumerate(SPEC)]
    want = {c.uid: c.tokens for c in ServeEngine(cfg, params, **kw).run(reqs())}
    eng = ServeEngine(cfg, params, mesh=make_serve_mesh(8, ["cpu"] * 8), **kw)
    assert {c.uid: c.tokens for c in eng.run(reqs())} == want


@pytest.mark.parametrize("paged", [False, True])
def test_two_shards_equal_one_at_their_lane_counts(ref, paged):
    """dp = 2 against dp = 1 with twice the prefill lanes and every chunk
    dispatch padded to two lanes (``parity.pad_chunk_lanes``: the lane
    counts of ``[dp, P_local]``): the same tokens and every logits row
    equal bit for bit.  The card's sharded phase holds its bf16 dp = 2 run
    to the same witness."""
    from repro_torch.benchmarks.parity import (compare, pad_chunk_lanes,
                                               record_logits)
    kw = dict(max_seq=64, n_slots=4, prefill_chunk=8, paged=paged,
              page_size=8)
    runs = {}
    for name, mesh, lanes in (("two", make_serve_mesh(2, ["cpu"] * 2), 2),
                              ("one", None, 4)):
        eng = _engine(ref, "", mesh=mesh, prefill_slots=lanes, **kw)
        if mesh is None:
            pad_chunk_lanes(eng, 2)
        rows = {}
        record_logits(eng, rows)
        got = eng.run([Request(uid=f"r{i}", tokens=ref["prompts"][i],
                               max_new_tokens=6, k=(8, 4, None)[i % 3])
                       for i in range(len(SPEC))])
        runs[name] = ({c.uid: c.tokens for c in got}, rows)
    c = compare(*runs["one"], *runs["two"], row_tol=0.0)
    assert c["ok"] and not c["partings"]
    assert c["rows_equal"] == c["rows"] == 6 * len(SPEC)


def test_sparse_stats_sharded_matches_the_reference(ref):
    st = ref["stats"]
    mesh = make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    m, l, o = swa._sparse_stats_sharded(
        torch.from_numpy(st["q"]), to_torch(st["cache"], device="cpu"),
        SwanConfig(k_max=8, buffer=4, mode="topk"),
        torch.from_numpy(st["sp_len"]), mesh, "model")
    for got, name in ((m, "m"), (l, "l"), (o, "o")):
        np.testing.assert_allclose(got.numpy(), st[name], atol=5e-5,
                                   rtol=5e-5)


def test_split_s_rules_leave_the_decode_unchanged(ref):
    """Rules that split the sparse sequence over a mesh axis route the
    decode through ``_sparse_stats_sharded``: the logits equal the plain
    read's; with no rules the path is the unsharded one."""
    cfg = _cfg()
    api = get_model(cfg)
    swan = SwanConfig(k_max=8, buffer=4, mode="topk")
    p, pj = ref["t"]["absorbed"], ref["t"]["pj"]
    toks = torch.tensor([ref["prompts"][2][:16]] * 4)

    def decode(rules):
        st = api.init_serve_state(cfg, swan, 4, 64, "cpu")
        api.prefill(p, cfg, {"tokens": toks}, st, swan, pj)
        with use_rules(rules):
            return api.decode_step(p, cfg, toks[:, -1], torch.full((4,), 16),
                                   st, swan, pj)[0]
    calls = []
    real = swa._sparse_stats_sharded

    def spy(*a, **kw):
        calls.append(a[-1])
        return real(*a, **kw)
    mesh = make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    rules = ShardingRules(mesh, {"swan_sparse": P("data", None, "model",
                                                  None)})
    swa._sparse_stats_sharded = spy
    try:
        plain = decode(None)
        assert not calls
        split = decode(rules)
    finally:
        swa._sparse_stats_sharded = real
    assert calls == ["model"] * cfg.n_layers
    np.testing.assert_allclose(split.numpy(), plain.numpy(), atol=5e-5)


def test_split_s_rules_keep_the_kernel_gate(ref, monkeypatch):
    """Under rules that split the sparse sequence over a mesh axis, a cache
    the kernel gate admits (on the card) is read by the decode kernel, not
    by the plain split-S path: the mesh lies on one device and the kernel
    is split-S itself.  The gate and the kernel wrapper are stood in for
    here (the wrapper computes the plain read), so the route is what is
    held."""
    from repro_torch.models import transformer
    cfg = _cfg()
    api = get_model(cfg)
    swan = SwanConfig(k_max=8, buffer=4, mode="topk")
    p, pj = ref["t"]["absorbed"], ref["t"]["pj"]
    toks = torch.tensor([ref["prompts"][2][:16]] * 4)
    st = api.init_serve_state(cfg, swan, 4, 64, "cpu")
    api.prefill(p, cfg, {"tokens": toks}, st, swan, pj)
    kernel, split = [], []

    def wrapper(q_hat, cache, swan_, pos):
        kernel.append(q_hat.shape)
        return swa.swan_decode_attention(q_hat, cache, swan_, pos)

    def no_split(*a, **kw):
        split.append(a[-1])
        raise AssertionError("the plain split-S path ran")
    monkeypatch.setattr(transformer, "kernel_supported", lambda *a: True)
    monkeypatch.setattr(transformer, "swan_decode_from_cache", wrapper)
    monkeypatch.setattr(swa, "_sparse_stats_sharded", no_split)
    mesh = make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    rules = ShardingRules(mesh, {"swan_sparse": P("data", None, "model",
                                                  None)})
    with use_rules(rules):
        api.decode_step(p, cfg, toks[:, -1], torch.full((4,), 16), st,
                        swan, pj)
    assert len(kernel) == cfg.n_layers and not split


# ---------------------------------------------------------------------------
# Topology validation (the reference test's in-process checks)
# ---------------------------------------------------------------------------

def test_state_specs_are_data_only_on_mixed_meshes(ref):
    """A mesh that also carries a 'model' axis keeps the cache sequence
    dims unsharded: every non-data axis is stripped from the specs."""
    mesh = make_mesh((1, 1), ("data", "model"), ["cpu"])
    cfg = _cfg()
    eng = ServeEngine(cfg, ref["t"]["absorbed"], max_seq=64, n_slots=2,
                      mesh=mesh, device="cpu")
    axes = set()

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            axes.update(ax for ax in tuple(t) if ax is not None)
    walk(eng._state_specs)
    assert "model" not in axes and axes <= {"data", ("data",)}
    req = [Request(uid="x", tokens=[1, 2, 3, 4, 5], max_new_tokens=3)]
    got = eng.run(req)
    want = ServeEngine(cfg, ref["t"]["absorbed"], max_seq=64, n_slots=2,
                       device="cpu").run(req)
    assert got[0].tokens == want[0].tokens


def test_layout_holds_the_state_specs(ref):
    """The engine's shard-major layout is checked against its data-only
    state specs at construction: a leaf split along a dim that is neither
    the slots nor the pool's pages, or along two dims, is refused."""
    from repro_torch.sharding.api import ShardLayout
    eng = _engine(ref, "paged", mesh=make_serve_mesh(8, ["cpu"] * 8))
    layout, specs = eng._layout, eng._state_specs
    layout.check_specs(eng.state, specs)
    bad = dict(specs, buf_pos=P(None, None, "data"))
    with pytest.raises(ValueError, match="shard-major"):
        layout.check_specs(eng.state, bad)
    bad = dict(specs, buf_pos=P("data", "data", None))
    with pytest.raises(ValueError, match="shard-major"):
        layout.check_specs(eng.state, bad)
    with pytest.raises(ValueError, match="shard-major"):
        ShardLayout(8, 1, eng.pool.pages_per_shard).check_specs(eng.state,
                                                                specs)


def test_engine_rejects_indivisible_mesh():
    class FakeMesh:
        axis_names = ("data",)
        shape = {"data": 3}
    with pytest.raises(ValueError, match="divisible"):
        ServeEngine(get_smoke_config("llama3-8b"), {}, max_seq=64,
                    n_slots=4, mesh=FakeMesh())


def test_engine_rejects_meshes_without_data_axis():
    class FakeMesh:
        axis_names = ("model",)
        shape = {"model": 2}
    with pytest.raises(ValueError, match="data"):
        ServeEngine(get_smoke_config("llama3-8b"), {}, max_seq=64,
                    n_slots=4, mesh=FakeMesh())


def test_engine_refuses_distinct_and_meta_meshes():
    cfg = get_smoke_config("llama3-8b")
    with pytest.raises(NotImplementedError, match="A.3"):
        ServeEngine(cfg, {}, max_seq=64, n_slots=4,
                    mesh=make_serve_mesh(2, ["cuda:0", "cuda:1"]))
    with pytest.raises(ValueError, match="meta"):
        ServeEngine(cfg, {}, max_seq=64, n_slots=256,
                    mesh=make_production_mesh())
    with pytest.raises(ValueError, match="model"):
        ServeEngine(cfg, {}, max_seq=64, n_slots=4, shard_params=True,
                    mesh=make_serve_mesh(2, ["cpu"] * 2), device="cpu")


def test_meshes():
    m = make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    assert dict(m.shape) == {"data": 2, "model": 4} and m.size == 8
    assert m.devices.shape == (2, 4)
    assert m.axis_names == ("data", "model")
    p = make_production_mesh(multi_pod=True)
    assert dict(p.shape) == {"pod": 2, "data": 16, "model": 16}
    assert {d.type for d in p.devices.flat} == {"meta"}
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="visible"):
            make_serve_mesh(2)
    with pytest.raises(ValueError, match="got 3"):
        make_serve_mesh(2, ["cpu"] * 3)
