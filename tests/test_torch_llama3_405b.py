"""llama3-405b in the port against the JAX package, on float32 smoke
configs with the reference's weights and projections carried across: the
published smoke config (3 layers, G = 4) and a G = 16 variant of it (32
query heads over 2 kv heads: the full config's group size, which the
decode kernels serve in two groups of 8).  The config fields, the
``lm_forward`` logits, lockstep greedy tokens and ``cache_report()``, the
engine's tokens, steps, dispatches and cache report with chunked
concurrent prefill on the slab and the paged pool, one training step with
the config's bfloat16 AdamW moments, and both serve launchers' tokens on
one reference checkpoint.  One reference pipeline per variant is shared by
the module."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import OptimizerConfig as JOpt  # noqa: E402
from repro.configs import SwanConfig as JSwan  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import serve as j_serve_cli  # noqa: E402
from repro.launch.io import make_batch as j_make_batch  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.optim.adamw import init_opt_state as j_init_opt  # noqa: E402
from repro.runtime.serve_engine import Request as JRequest  # noqa: E402
from repro.runtime.serve_engine import ServeEngine as JEngine  # noqa: E402
from repro.runtime.serve_loop import ServeSession as JSession  # noqa: E402
from repro.runtime.serve_loop import calibrate_swan as j_calibrate  # noqa: E402
from repro.runtime.train_loop import make_train_step as j_train_step  # noqa: E402
from repro_torch.configs import (OptimizerConfig, SwanConfig,  # noqa: E402
                                 get_config, get_smoke_config)
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.kernels.swan_decode.swan_decode import g_plan  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.io import make_batch  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.optim.adamw import init_opt_state  # noqa: E402
from repro_torch.runtime.serve_engine import Request, ServeEngine  # noqa: E402
from repro_torch.runtime.serve_loop import ServeSession  # noqa: E402
from repro_torch.runtime.train_loop import make_train_step  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves  # noqa: E402

ARCH = "llama3-405b"
F32 = dict(dtype="float32", param_dtype="float32")
# the published smoke config (G = 4) and the full config's group size
VARIANTS = {"g4": {}, "g16": dict(n_heads=32, n_kv_heads=2)}
LENS = [3, 9, 17, 20, 12]               # straddle chunk 8, pages 16, ring 4
LAYOUTS = {"slab": dict(prefill_chunk=8, prefill_slots=2),
           "paged": dict(paged=True, page_size=16, prefill_chunk=8,
                         prefill_slots=2)}
_REF = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref(variant):
    """The reference's f32 smoke pipeline for ``variant`` (weights,
    calibration, absorption, prompts) and its tensors in torch."""
    if variant not in _REF:
        jcfg = j_smoke(ARCH).replace(**F32, **VARIANTS[variant])
        japi = j_get_model(jcfg)
        params = japi.init_params(jax.random.PRNGKey(0), jcfg)
        pj = j_calibrate(japi, jcfg, params, j_make_batch(jcfg, 2, 24, seed=3))
        absorbed = japi.absorb(params, jcfg, pj)
        _REF[variant] = {
            "jcfg": jcfg,
            "tcfg": get_smoke_config(ARCH).replace(**F32, **VARIANTS[variant]),
            "params": params, "absorbed": absorbed, "pj": pj,
            "t": {n: to_torch(x, device="cpu") for n, x in
                  (("params", params), ("absorbed", absorbed), ("pj", pj))},
            "prompts": [np.asarray(j_make_batch(jcfg, 1, n, seed=40 + i)
                                   ["tokens"][0]).tolist()
                        for i, n in enumerate(LENS)]}
    return _REF[variant]


def test_config_fields_match_reference():
    """Every field of the full and smoke configs (the sharding fields and
    the bfloat16 AdamW moments included); the full config's G = 16 is two
    launches of the decode kernels' G = 8 instance."""
    for mine, theirs in ((get_config(ARCH), j_config(ARCH)),
                         (get_smoke_config(ARCH), j_smoke(ARCH))):
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
        assert mine.n_params() == theirs.n_params()
        assert mine.opt_state_dtype == "bfloat16" and mine.fsdp_data
    full = get_config(ARCH)
    assert (full.q_group, full.n_layers, full.d_model) == (16, 126, 16384)
    assert g_plan(full.q_group) == (8, 2, 8)
    assert get_smoke_config(ARCH).q_group == 4
    assert get_smoke_config(ARCH).replace(**VARIANTS["g16"]).q_group == 16


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_init_tree_matches_reference(variant):
    r = _ref(variant)
    tparams = get_model(r["tcfg"]).init_params(r["tcfg"], 0, "cpu")
    want = [(p, tuple(x.shape)) for p, x in flatten_with_path(r["t"]["params"])]
    assert [(p, tuple(x.shape)) for p, x in flatten_with_path(tparams)] == want


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_lm_forward_logits(variant):
    r = _ref(variant)
    jb = j_make_batch(r["jcfg"], 2, 24, seed=1)
    jl, _ = j_get_model(r["jcfg"]).forward(r["params"], r["jcfg"], jb)
    tl = get_model(r["tcfg"]).forward(
        r["t"]["params"], r["tcfg"], make_batch(r["tcfg"], 2, 24, seed=1,
                                                device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-5)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_lockstep_matches_reference(variant):
    """Prefill and first-decode logits within 5e-5, greedy tokens equal,
    the same cache report."""
    r = _ref(variant)
    k = r["jcfg"].d_head // 2
    jsess = JSession(r["jcfg"], r["absorbed"], swan=JSwan(k_max=k, buffer=4),
                     projections=r["pj"], max_seq=64, batch=2)
    tsess = ServeSession(r["tcfg"], r["t"]["absorbed"],
                         swan=SwanConfig(k_max=k, buffer=4),
                         projections=r["t"]["pj"], max_seq=64, batch=2,
                         device="cpu")
    jb = j_make_batch(r["jcfg"], 2, 16, seed=1)
    tb = make_batch(r["tcfg"], 2, 16, seed=1, device="cpu")
    jl0, tl0 = jsess.prefill(jb), tsess.prefill(tb)
    np.testing.assert_allclose(tl0.numpy(), np.asarray(jl0), atol=5e-5)
    tok = np.asarray(jnp.argmax(jl0, axis=-1))
    jl1 = jsess.decode(jnp.asarray(tok))
    tl1 = tsess.decode(torch.as_tensor(tok))
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), atol=5e-5)
    j_out = jsess.generate(jb, 12)
    t_out = tsess.generate(tb, 12)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    assert tsess.cache_report() == jsess.cache_report()


def _engine(cls, swan_cls, cfg, weights, layout, **extra):
    k = cfg.d_head // 2
    return cls(cfg, weights["absorbed"], swan=swan_cls(k_max=k, buffer=4),
               projections=weights["pj"], max_seq=64, n_slots=2,
               **LAYOUTS[layout], **extra)


def _requests(cls, cfg, prompts):
    k_cycle = [None, cfg.d_head // 4]
    return [cls(uid=f"r{i}", tokens=p, max_new_tokens=6, k=k_cycle[i % 2])
            for i, p in enumerate(prompts)]


def _summary(eng, comps):
    return ({c.uid: (c.tokens, c.admitted_step, c.first_token_step,
                     c.finished_step) for c in comps},
            eng.step_count, eng.dispatches, eng.cache_report())


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_engine_matches_reference(variant, layout):
    r = _ref(variant)
    eng = _engine(JEngine, JSwan, r["jcfg"], r, layout)
    want = _summary(eng, eng.run(_requests(JRequest, r["jcfg"],
                                           r["prompts"])))
    eng = _engine(ServeEngine, SwanConfig, r["tcfg"], r["t"], layout,
                  device="cpu")
    got = _summary(eng, eng.run(_requests(Request, r["tcfg"], r["prompts"])))
    assert got[0] == want[0]                  # tokens and step stamps
    assert got[1:3] == want[1:3]              # engine steps, dispatches
    assert got[3] == want[3]                  # cache_report


# The largest |port - reference| of an updated parameter after one AdamW
# step at lr 1e-2 is of the size tests/test_torch_dense_family.py measured
# (9.3e-5 for yi-9b's f32 moments, where a gradient near zero meets Adam's
# first-step g / (|g| + eps)); its bound is kept.
STEP_PARAM_GAP = 6e-4
# the bfloat16 moments' bound of tests/test_torch_optim.py: max |a - b|
# within 1e-2 of the leaf's scale
MOMENT_REL = 1e-2


def test_train_step_with_bf16_moments_matches_reference():
    """One optimizer step from the reference's weights with the config's
    ``opt_state_dtype`` (bfloat16) moments in both packages: the loss, the
    updated parameters, and each moment leaf in bfloat16 within the
    optimizer tests' bound."""
    r = _ref("g4")
    jcfg, tcfg = r["jcfg"], r["tcfg"]
    assert tcfg.opt_state_dtype == jcfg.opt_state_dtype == "bfloat16"
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (4, 17)).astype(np.int32)
    opt = dict(lr=1e-2, warmup_steps=1, decay_steps=5)
    jopt_cfg = JOpt(state_dtype=jcfg.opt_state_dtype, **opt)
    topt_cfg = OptimizerConfig(state_dtype=tcfg.opt_state_dtype, **opt)
    jp2, jo2, jm = j_train_step(jcfg, jopt_cfg)(
        r["params"], j_init_opt(r["params"], jopt_cfg),
        {"tokens": jnp.asarray(tokens)})
    tp = to_torch(r["params"], device="cpu")
    tp2, to2, tm = make_train_step(tcfg, topt_cfg)(
        tp, init_opt_state(tp, topt_cfg), {"tokens": torch.as_tensor(tokens)})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=5e-5, rtol=0)
    gap = max(float(np.max(np.abs(a.numpy() - np.asarray(b))))
              for a, b in zip(leaves(tp2), jax.tree_util.tree_leaves(jp2)))
    assert gap <= STEP_PARAM_GAP, gap
    for name in ("m", "v"):
        for (path, a), b in zip(flatten_with_path(to2[name]),
                                jax.tree_util.tree_leaves(jo2[name])):
            assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16, path
            b = np.asarray(b, np.float32)
            err = float(np.max(np.abs(a.float().numpy() - b)))
            assert err <= MOMENT_REL * float(np.max(np.abs(b))), (name, path)


LAUNCH = {"lockstep": [],
          "paged": ["--engine", "--requests", "3", "--paged",
                    "--page-size", "16", "--prefill-chunk", "8",
                    "--prefill-slots", "2"]}


@pytest.mark.parametrize("variant,mode", [("g4", "lockstep"),
                                          ("g16", "lockstep"),
                                          ("g16", "paged")])
def test_serve_launcher_tokens_match_reference(variant, mode, tmp_path,
                                               capsys, monkeypatch):
    """Both serve launchers on the same float32 checkpoint (the
    reference's weights), each calibrating SWAN itself: the same tokens
    (the lockstep sequences, or the paged engine's first two requests with
    chunked concurrent prefill; the engine's other settings are held to
    the reference by ``test_engine_matches_reference``)."""
    r = _ref(variant)
    JCheckpointer(str(tmp_path)).save(0, {"params": r["params"]})
    argv = ["--arch", ARCH, "--smoke", "--swan", "--k", "4", "--buffer", "4",
            "--tokens", "5", "--batch", "2", "--prompt-len", "12",
            "--max-seq", "64", "--ckpt-dir", str(tmp_path)] + LAUNCH[mode]
    monkeypatch.setattr(j_serve_cli, "get_smoke_config",
                        lambda a: j_smoke(a).replace(**F32, **VARIANTS[variant]))
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    j_serve_cli.main()

    def tokens(out):
        return [ln.split(":", 1)[-1] for ln in out.splitlines()
                if ln.startswith(("seq ", "req"))]
    want = tokens(capsys.readouterr().out)
    monkeypatch.setattr(serve_cli, "get_smoke_config",
                        lambda a: get_smoke_config(a).replace(
                            **F32, **VARIANTS[variant]))
    serve_cli.main(argv + ["--device", "cpu"])
    assert tokens(capsys.readouterr().out) == want and len(want) == 2


def test_train_launcher_runs_on_cpu(tmp_path, capsys):
    """The port's training launcher on the smoke config: finite losses,
    with the config's bfloat16 moments in the trainer's state."""
    out = train_cli.main(["--arch", ARCH, "--smoke", "--steps", "3",
                          "--batch", "2", "--seq", "16", "--ckpt-dir",
                          str(tmp_path), "--device", "cpu"])
    assert out["step"] == 3
    assert all(np.isfinite(row["loss"]) for row in out["log"])
    assert {x.dtype for x in leaves(out["opt"]["m"]) + leaves(
        out["opt"]["v"])} == {torch.bfloat16}
    assert "finished at step 3" in capsys.readouterr().out
