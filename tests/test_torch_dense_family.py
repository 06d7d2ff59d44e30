"""The rest of the dense family in the port against the JAX package, on the
yi-9b (GQA, G = 8) and olmo-1b (MHA, non-parametric LayerNorm, tied
embeddings) smoke configs at float32, with the reference's weights and
projections carried across: the config fields, ``lm_forward`` logits,
lockstep greedy tokens at k = d_head/2 and d_head with ``cache_report()``,
the engine's tokens, steps, dispatches and cache report with chunked
concurrent prefill on the slab and the paged pool, one training step's
loss, gradients and updated parameters (a tied embedding takes the sum of
both uses' gradients), and a checkpoint restored across the packages bit
for bit.  One reference pipeline per arch is shared by the module."""
import dataclasses

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
from repro.launch.io import make_batch as j_make_batch  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.optim.adamw import init_opt_state as j_init_opt  # noqa: E402
from repro.runtime.serve_engine import Request as JRequest  # noqa: E402
from repro.runtime.serve_engine import ServeEngine as JEngine  # noqa: E402
from repro.runtime.serve_loop import ServeSession as JSession  # noqa: E402
from repro.runtime.serve_loop import calibrate_swan as j_calibrate  # noqa: E402
from repro.runtime.train_loop import make_train_step as j_train_step  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import (OptimizerConfig, SwanConfig,  # noqa: E402
                                 get_config, get_smoke_config)
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.io import make_batch  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.optim.adamw import init_opt_state  # noqa: E402
from repro_torch.runtime.serve_engine import Request, ServeEngine  # noqa: E402
from repro_torch.runtime.serve_loop import ServeSession  # noqa: E402
from repro_torch.runtime.train_loop import make_train_step  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves, unflatten  # noqa: E402

ARCHS = ["yi-9b", "olmo-1b"]
F32 = dict(dtype="float32", param_dtype="float32")
LENS = [3, 9, 17, 20, 12, 30, 5]        # straddle chunk 8, pages 16, ring 4
LAYOUTS = {"slab": dict(prefill_chunk=8, prefill_slots=2),
           "paged": dict(paged=True, page_size=16, prefill_chunk=8,
                         prefill_slots=2)}
_REF = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: hundreds of tiny eager ops, which extra threads
    only slow down when the suite's workers share the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref(arch):
    """The reference's f32 smoke pipeline for ``arch`` (weights,
    calibration, absorption, prompts), its tensors in torch, and a cache of
    its runs."""
    if arch not in _REF:
        jcfg = j_smoke(arch).replace(**F32)
        japi = j_get_model(jcfg)
        params = japi.init_params(jax.random.PRNGKey(0), jcfg)
        pj = j_calibrate(japi, jcfg, params, j_make_batch(jcfg, 2, 24, seed=3))
        absorbed = japi.absorb(params, jcfg, pj)
        _REF[arch] = {
            "jcfg": jcfg, "tcfg": get_smoke_config(arch).replace(**F32),
            "params": params, "absorbed": absorbed, "pj": pj,
            "t": {n: to_torch(x, device="cpu") for n, x in
                  (("params", params), ("absorbed", absorbed), ("pj", pj))},
            "prompts": [np.asarray(j_make_batch(jcfg, 1, n, seed=40 + i)
                                   ["tokens"][0]).tolist()
                        for i, n in enumerate(LENS)],
            "runs": {}}
    return _REF[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_reference(arch):
    for mine, theirs in ((get_config(arch), j_config(arch)),
                         (get_smoke_config(arch), j_smoke(arch))):
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(theirs, f.name), f.name


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference(arch):
    """The port's own init has the reference's leaves (olmo: no norm
    leaves, no head)."""
    r = _ref(arch)
    tparams = get_model(r["tcfg"]).init_params(r["tcfg"], 0, "cpu")
    want = [(p, tuple(x.shape)) for p, x in flatten_with_path(r["t"]["params"])]
    assert [(p, tuple(x.shape)) for p, x in flatten_with_path(tparams)] == want
    tied = r["tcfg"].tie_embeddings
    assert ("head" in tparams) != tied
    assert (tparams["ln_f"] == {}) == (r["tcfg"].norm == "nonparam_ln")


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_norms_match_reference(norm):
    """Each of the reference's norms, its parameters perturbed from their
    init (LayerNorm's bias included), on the same input at f32."""
    from repro.models import common as jcommon
    from repro_torch.models import common as tcommon
    jcfg = j_smoke("olmo-1b").replace(norm=norm, **F32)
    tcfg = get_smoke_config("olmo-1b").replace(norm=norm, **F32)
    rng = np.random.default_rng(0)
    jp = {k: np.asarray(v) + rng.normal(size=v.shape).astype(np.float32)
          for k, v in jcommon.init_norm(None, jcfg, jcfg.d_model).items()}
    tp = tcommon.init_norm(tcfg, (), "cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in jp.items()}
    x = rng.normal(size=(3, 5, jcfg.d_model)).astype(np.float32) * 3 + 1
    want = jcommon.apply_norm(jp, jcfg, jnp.asarray(x))
    got = tcommon.apply_norm(to_torch(jp, device="cpu"), tcfg,
                             torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_logits(arch):
    r = _ref(arch)
    jb = j_make_batch(r["jcfg"], 2, 24, seed=1)
    jl, _ = j_get_model(r["jcfg"]).forward(r["params"], r["jcfg"], jb)
    tl = get_model(r["tcfg"]).forward(
        r["t"]["params"], r["tcfg"], make_batch(r["tcfg"], 2, 24, seed=1,
                                                device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-5)


@pytest.mark.parametrize("k_frac", ["half", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lockstep_tokens_match_reference(arch, k_frac):
    r = _ref(arch)
    dh = r["jcfg"].d_head
    k = dh // 2 if k_frac == "half" else dh
    jsess = JSession(r["jcfg"], r["absorbed"], swan=JSwan(k_max=k, buffer=4),
                     projections=r["pj"], max_seq=64, batch=2)
    tsess = ServeSession(r["tcfg"], r["t"]["absorbed"],
                         swan=SwanConfig(k_max=k, buffer=4),
                         projections=r["t"]["pj"], max_seq=64, batch=2,
                         device="cpu")
    j_out = jsess.generate(j_make_batch(r["jcfg"], 2, 16, seed=1), 14)
    t_out = tsess.generate(make_batch(r["tcfg"], 2, 16, seed=1, device="cpu"),
                           14)
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
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(arch, layout):
    r = _ref(arch)
    if layout not in r["runs"]:
        eng = _engine(JEngine, JSwan, r["jcfg"], r, layout)
        r["runs"][layout] = _summary(
            eng, eng.run(_requests(JRequest, r["jcfg"], r["prompts"])))
    want = r["runs"][layout]
    eng = _engine(ServeEngine, SwanConfig, r["tcfg"], r["t"], layout,
                  device="cpu")
    got = _summary(eng, eng.run(_requests(Request, r["tcfg"], r["prompts"])))
    assert got[0] == want[0]                  # tokens and step stamps
    assert got[1:3] == want[1:3]              # engine steps, dispatches
    assert got[3] == want[3]                  # cache_report


# The largest |port - reference| of an updated parameter after one AdamW
# step at lr 1e-2, measured on this test's setup on an x86 CPU: 9.3e-5
# (yi-9b) and 1.9e-4 (olmo-1b), where a gradient near zero meets Adam's
# first-step normalisation g / (|g| + eps); the bound is 3x the larger.
STEP_PARAM_GAP = 6e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One optimizer step from the reference's weights: the loss, every
    gradient (olmo's tied embedding takes the lookup's and the head's),
    and the updated parameters."""
    r = _ref(arch)
    jcfg, tcfg = r["jcfg"], r["tcfg"]
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (4, 17)).astype(np.int32)
    opt = dict(lr=1e-2, warmup_steps=1, decay_steps=5)
    jp, jopt = r["params"], j_init_opt(r["params"], JOpt(**opt))
    jp2, _, jm = j_train_step(jcfg, JOpt(**opt))(
        jp, jopt, {"tokens": jnp.asarray(tokens)})
    tp = to_torch(jp, device="cpu")
    flat = [x.detach().requires_grad_() for x in leaves(tp)]
    loss, _ = get_model(tcfg).loss(unflatten(tp, flat), tcfg,
                                   {"tokens": torch.as_tensor(tokens)})
    tg = torch.autograd.grad(loss, flat)
    japi = j_get_model(jcfg)
    jg = jax.grad(lambda p: japi.loss(p, jcfg, {"tokens": jnp.asarray(
        tokens)})[0])(jp)
    for (path, _), a, b in zip(flatten_with_path(tp), tg,
                               jax.tree_util.tree_leaves(jg)):
        b = np.asarray(b)
        assert np.max(np.abs(a.numpy() - b)) <= 1e-4 * np.max(np.abs(b)), path
    tp2, _, tm = make_train_step(tcfg, OptimizerConfig(**opt))(
        tp, init_opt_state(tp, OptimizerConfig(**opt)),
        {"tokens": torch.as_tensor(tokens)})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=5e-5, rtol=0)
    gap = max(float(np.max(np.abs(a.numpy() - np.asarray(b))))
              for a, b in zip(leaves(tp2), jax.tree_util.tree_leaves(jp2)))
    print(f"one-step param gap [{arch}]: {gap:.3e}")
    assert gap <= STEP_PARAM_GAP, gap


def _bits(x):
    """A leaf's bits as a torch tensor (bfloat16 as int16)."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        x = torch.as_tensor(a.view(np.int16) if a.dtype.name == "bfloat16"
                            else a)
    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_olmo_checkpoint_across_packages(tmp_path, direction):
    """olmo-1b's bf16 params (empty norm dicts, no head) and AdamW state
    saved by one package restore in the other bit for bit."""
    jcfg = j_smoke("olmo-1b")
    jp = j_get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    tree = {"params": jp, "opt": j_init_opt(jp, JOpt())}
    tcfg = get_smoke_config("olmo-1b")
    tp = get_model(tcfg).init_params(tcfg, 5, "cpu")
    like = {"params": tp, "opt": init_opt_state(tp, OptimizerConfig())}
    if direction == "reference_to_port":
        JCheckpointer(str(tmp_path)).save(3, tree)
        out = Checkpointer(str(tmp_path)).restore(3, like)
        assert out["params"]["ln_f"] == {} and "head" not in out["params"]
        want = jax.tree_util.tree_leaves(tree)
    else:
        src = to_torch(tree, device="cpu")
        Checkpointer(str(tmp_path)).save(3, src)
        out = JCheckpointer(str(tmp_path)).restore(3, tree)
        want = leaves(src)
        assert out["params"]["layers"]["ln1"] == {}
        out = jax.tree_util.tree_leaves(out)
    got = leaves(out) if isinstance(out, dict) else out
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("engine", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_on_cpu(arch, engine, capsys):
    argv = ["--arch", arch, "--smoke", "--swan", "--k", "4", "--buffer", "4",
            "--tokens", "3", "--batch", "2", "--prompt-len", "12",
            "--max-seq", "64", "--device", "cpu"]
    if engine:
        argv += ["--engine", "--requests", "3", "--mixed-k", "--paged",
                 "--page-size", "16", "--prefill-chunk", "8",
                 "--prefill-slots", "2"]
    serve_cli.main(argv)
    out = capsys.readouterr().out
    assert ("engine: 3 requests, 9 tokens" in out if engine
            else "cache [swan[topk]]" in out)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_runs_on_cpu(arch, tmp_path, capsys):
    out = train_cli.main(["--arch", arch, "--smoke", "--steps", "3",
                          "--batch", "2", "--seq", "16", "--ckpt-dir",
                          str(tmp_path), "--device", "cpu"])
    assert out["step"] == 3
    assert all(np.isfinite(r["loss"]) for r in out["log"])
    assert "finished at step 3" in capsys.readouterr().out
