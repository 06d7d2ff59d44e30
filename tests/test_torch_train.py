"""Port parity for the training stack on the f32 llama3-8b smoke config:
the loss and its gradients against ``jax.value_and_grad`` of the
reference's, remat and gradient accumulation, int8 gradient compression,
and the Trainer over five steps in both packages from one checkpoint the
reference wrote; the watchdog and the preemption path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import OptimizerConfig as JOpt  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim.adamw import init_opt_state as j_init_opt  # noqa: E402
from repro.runtime import grad_compress as jgc  # noqa: E402
from repro.runtime.train_loop import Trainer as JTrainer  # noqa: E402
from repro_torch.configs import (OptimizerConfig, TrainConfig,  # noqa: E402
                                 get_smoke_config)
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.optim.adamw import init_opt_state  # noqa: E402
from repro_torch.runtime import grad_compress as tgc  # noqa: E402
from repro_torch.runtime.fault_tolerance import StepWatchdog  # noqa: E402
from repro_torch.runtime.train_loop import Trainer, make_train_step  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves, unflatten  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run hundreds of tiny eager ops,
    which extra threads only slow down when the suite's workers share the
    cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    jcfg = j_smoke("llama3-8b").replace(**F32)
    tcfg = get_smoke_config("llama3-8b").replace(**F32)
    jparams = j_get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (4, 17))
    return jcfg, tcfg, jparams, tokens.astype(np.int32)


def _grads(tcfg, tparams, batch, loss_fn=None):
    flat = [x.detach().requires_grad_() for x in leaves(tparams)]
    p = unflatten(tparams, flat)
    fn = loss_fn or get_model(tcfg).loss
    loss, _ = fn(p, tcfg, batch)
    return loss, [g for g in torch.autograd.grad(loss, flat)]


def _close(a, b, rel, what=""):
    """Relative to the leaf's scale: max |a - b| <= rel * max |b|."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    err = float(np.max(np.abs(a - b)))
    assert err <= rel * max(float(np.max(np.abs(b))), 1e-30), (what, err)


def test_loss_and_grads_match_reference(pair):
    jcfg, tcfg, jparams, tokens = pair
    japi = j_get_model(jcfg)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: japi.loss(p, jcfg, {"tokens": jnp.asarray(tokens)}),
        has_aux=True)(jparams)
    tl, tg = _grads(tcfg, to_torch(jparams, device="cpu"),
                    {"tokens": torch.as_tensor(tokens)})
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=5e-5,
                               rtol=0)
    for (path, a), b in zip(
            flatten_with_path(to_torch(jparams, device="cpu")),
            zip(tg, jax.tree_util.tree_leaves(jg))):
        _close(b[0].numpy(), b[1], 1e-4, path)


def test_lm_loss_masked_matches_reference(pair):
    jcfg, tcfg, jparams, tokens = pair
    mask = (np.arange(17)[None] % 3 != 0).repeat(4, 0).astype(np.int32)
    jl, jm = jtfm.lm_loss(jparams, jcfg, {"tokens": jnp.asarray(tokens),
                                          "loss_mask": jnp.asarray(mask)})
    tl, tm = tfm.lm_loss(to_torch(jparams, device="cpu"), tcfg,
                         {"tokens": torch.as_tensor(tokens),
                          "loss_mask": torch.as_tensor(mask)})
    for k in ("nll", "z"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=5e-5,
                                   rtol=0)
    np.testing.assert_allclose(float(tl), float(jl), atol=5e-5, rtol=0)


def test_remat_policies_give_equal_grads(pair):
    _, tcfg, jparams, tokens = pair
    tparams = to_torch(jparams, device="cpu")
    batch = {"tokens": torch.as_tensor(tokens)}
    runs = [_grads(tcfg.replace(remat=r, remat_policy=pol), tparams, batch)
            for r, pol in ((False, "full"), (True, "full"), (True, "dots"))]
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for a, b in zip(grads, runs[0][1]):
            assert torch.equal(a, b)


def test_grad_accum_matches_single_batch(pair, monkeypatch):
    """Two microbatches accumulated in f32 give the one-batch gradient and
    loss (the gradients the optimizer receives, captured)."""
    from repro_torch.runtime import train_loop
    _, tcfg, jparams, tokens = pair
    opt = OptimizerConfig(lr=1e-2, warmup_steps=1)
    batch = {"tokens": torch.as_tensor(tokens)}
    seen = []
    real = train_loop.adamw_update

    def capture(params, grads, state, cfg):
        seen.append([g.clone() for g in leaves(grads)])
        return real(params, grads, state, cfg)

    monkeypatch.setattr(train_loop, "adamw_update", capture)
    losses = []
    for accum in (1, 2):
        p = to_torch(jparams, device="cpu")
        _, _, m = make_train_step(tcfg, opt, grad_accum=accum)(
            p, init_opt_state(p, opt), batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses[1], losses[0], atol=1e-5, rtol=0)
    assert seen[1][0].dtype == torch.float32
    for (path, _), a, b in zip(flatten_with_path(jparams), seen[1], seen[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0,
                                   err_msg=path)


@pytest.mark.parametrize("n", [1000, 4096, 9000])
def test_int8_compression_matches_reference(n):
    g = np.random.default_rng(n).standard_normal((n,)).astype(np.float32)
    g[:7] = [0.5, -0.5, 1.5, 2.5, -2.5, 0.0, 3.0]     # ties at the grid
    jg, tg = {"w": jnp.asarray(g)}, {"w": torch.as_tensor(g)}
    jq, js = jgc._quantize_leaf(jg["w"])
    tq, ts = tgc._quantize_leaf(tg["w"])
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tgc.compress_gradients(tg)["w"].numpy(),
                                  np.asarray(jgc.compress_gradients(jg)["w"]))
    jr, tr = jgc.residuals(jg), tgc.residuals(tg)
    np.testing.assert_array_equal(tr["w"].numpy(), np.asarray(jr["w"]))
    np.testing.assert_array_equal(
        tgc.compress_gradients(tg, error_feedback=tr)["w"].numpy(),
        np.asarray(jgc.compress_gradients(jg, error_feedback=jr)["w"]))
    (tq2, ts2) = tgc.quantize_tree(tg)["w"]
    (jq2, js2) = jgc.quantize_tree(jg)["w"]
    np.testing.assert_array_equal(tq2.numpy(), np.asarray(jq2))
    np.testing.assert_array_equal(ts2.numpy(), np.asarray(js2))


def _train_cfgs(tmp_path, tag):
    kw = dict(seq_len=16, global_batch=4, steps=5, log_every=1,
              checkpoint_every=100, async_checkpoint=False,
              checkpoint_dir=str(tmp_path / tag))
    opt = dict(lr=1e-2, warmup_steps=2, decay_steps=5)
    jtc = JTrainConfig(model=j_smoke("llama3-8b").replace(**F32),
                       optimizer=JOpt(**opt), **kw)
    ttc = TrainConfig(model=get_smoke_config("llama3-8b").replace(**F32),
                      optimizer=OptimizerConfig(**opt),
                      **{**kw, "checkpoint_dir": str(tmp_path / (tag + "_t"))})
    return jtc, ttc


# The largest |port - reference| of a final parameter after five steps at
# lr 1e-2, measured on this test's setup on an x86 CPU: 5.9e-5 without
# compression, 1.7e-3 with int8 (where the two packages' gradients
# straddle a rounding boundary of the int8 grid, one element moves by a
# whole grid step, and Adam's normalisation turns that into up to lr a
# step).  Bounds at about 3x the measurement.
FINAL_PARAM_GAP = {"none": 2e-4, "int8": 5e-3}


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_trainer_matches_reference(tmp_path, pair, compression):
    """Both trainers start from one step-0 checkpoint written by the
    reference and take five steps on the same synthetic batches."""
    jcfg, _, jparams, _ = pair
    jtc, ttc = _train_cfgs(tmp_path, compression)
    jtc = jtc.__class__(**{**jtc.__dict__, "grad_compression": compression})
    ttc = ttc.__class__(**{**ttc.__dict__, "grad_compression": compression})
    state = {"params": jparams, "opt": j_init_opt(jparams, jtc.optimizer)}
    JCheckpointer(jtc.checkpoint_dir).save(0, state)
    JCheckpointer(ttc.checkpoint_dir).save(0, state)
    jout = JTrainer(jtc, donate=False).run()
    tout = Trainer(ttc, device="cpu").run()
    assert tout["step"] == jout["step"] == 5
    jl = [r["loss"] for r in jout["log"]]
    tl = [r["loss"] for r in tout["log"]]
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    gap = max(float(np.max(np.abs(a.numpy() - np.asarray(b))))
              for a, b in zip(leaves(tout["params"]),
                              jax.tree_util.tree_leaves(jout["params"])))
    print(f"final param gap [{compression}]: {gap:.3e}")
    assert gap <= FINAL_PARAM_GAP[compression], gap


def test_preemption_triggers_checkpoint(tmp_path):
    cfg = get_smoke_config("llama3-8b").replace(remat=False)
    tc = TrainConfig(model=cfg, seq_len=16, global_batch=4, steps=50,
                     optimizer=OptimizerConfig(lr=1e-3),
                     checkpoint_dir=str(tmp_path), checkpoint_every=1000,
                     log_every=1, async_checkpoint=False)
    tr = Trainer(tc, device="cpu")
    tr.preemption.trigger()                      # simulate SIGTERM
    out = tr.run()
    assert out["step"] == 1                       # stopped at first step
    assert tr.ckpt.latest_step() == 1             # but saved its state
    tr.preemption.close()


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(threshold=2.0, warmup_steps=1)
    for i in range(5):
        wd.record(i, 1.0)
    assert wd.record(5, 5.0) is True
    assert wd.stragglers[-1][0] == 5
    assert wd.record(6, 1.0) is False            # EMA not poisoned
    assert abs(wd.ema - 1.0) < 0.05


def test_trainer_refuses_the_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, ttc = _train_cfgs(tmp_path, "nocard")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(ttc)
