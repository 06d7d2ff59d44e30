"""Port parity for AdamW: the port's update, schedule, clipping and decay
mask against the reference's on the same numpy params, grads and state."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import OptimizerConfig as JOpt  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.configs import OptimizerConfig  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402

KW = dict(lr=1e-2, warmup_steps=3, decay_steps=12, weight_decay=0.1,
          grad_clip=1.0)


def _tree(rng, dtype):
    """A stacked-layer tree with norm, bias and matrix leaves."""
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32).astype(dtype)
    return {"embed": a(16, 8), "head": a(8, 16), "ln_f": {"scale": a(8)},
            "layers": {"ln1": {"scale": a(2, 8)},
                       "attn": {"wq": a(2, 8, 8), "bq": a(2, 8)},
                       "mlp": {"w_up": a(2, 8, 24)}}}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


def _close(a, b, rel, what):
    """Relative to the leaf's scale: max |a - b| <= rel * max |b|."""
    err = float(np.max(np.abs(a - b)))
    assert err <= rel * float(np.max(np.abs(b))), (what, err)


@pytest.mark.parametrize("pdt,sdt", [("float32", "float32"),
                                     ("float32", "bfloat16"),
                                     ("bfloat16", "float32"),
                                     ("bfloat16", "bfloat16")])
def test_adamw_update_matches_reference(pdt, sdt):
    rng = np.random.default_rng(0)
    npdt = np.float32 if pdt == "float32" else ml_dtypes.bfloat16
    p_np = _tree(rng, npdt)
    jcfg, tcfg = JOpt(state_dtype=sdt, **KW), OptimizerConfig(state_dtype=sdt,
                                                              **KW)
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    js = jadamw.init_opt_state(jp, jcfg)
    tp = to_torch(p_np, device="cpu")
    ts = tadamw.init_opt_state(tp, tcfg)
    rel = 1e-6 if (pdt, sdt) == ("float32", "float32") else 1e-2
    for step in range(5):                       # warmup and decay, clipped
        g_np = jax.tree_util.tree_map(
            lambda x: (rng.standard_normal(x.shape) * (3 if step % 2 else 0.1)
                       ).astype(np.float32).astype(x.dtype), p_np)
        jp, js, jm = jadamw.adamw_update(
            jp, jax.tree_util.tree_map(jnp.asarray, g_np), js, jcfg)
        tp, ts, tm = tadamw.adamw_update(tp, to_torch(g_np, device="cpu"),
                                         ts, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert float(tm["lr"]) == float(jm["lr"])
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for tree_t, tree_j in ((tp, jp), (ts["m"], js["m"]),
                               (ts["v"], js["v"])):
            for (path, a), b in zip(flatten_with_path(tree_t),
                                    jax.tree_util.tree_leaves(tree_j)):
                assert str(a.dtype).split(".")[-1] == str(b.dtype), path
                _close(_np(a), _np(b), rel, path)


def test_lr_schedule_equal():
    cfg = dict(lr=3e-4, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1)
    for s in list(range(0, 14)) + [37, 55, 99, 100, 150]:
        want = float(jadamw.lr_schedule(jnp.asarray(s, jnp.int32),
                                        JOpt(**cfg)))
        got = float(tadamw.lr_schedule(torch.tensor(s, dtype=torch.int32),
                                       OptimizerConfig(**cfg)))
        assert got == want, (s, got, want)


def test_clip_and_decay_mask_equal():
    rng = np.random.default_rng(1)
    g_np = _tree(rng, np.float32)
    g_np = jax.tree_util.tree_map(lambda x: x * 10, g_np)
    jg, jn = jadamw.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, g_np), 1.0)
    tg, tn = tadamw.clip_by_global_norm(to_torch(g_np, device="cpu"), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(tadamw.global_norm(tg)), 1.0, rtol=1e-5)
    for (path, a), b in zip(flatten_with_path(tg),
                            jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-8, err_msg=path)
    jmask = jax.tree_util.tree_leaves(jadamw._decay_mask(g_np))
    tmask = [m for _, m in flatten_with_path(tadamw._decay_mask(
        to_torch(g_np, device="cpu")))]
    assert tmask == [float(m) for m in jmask]
    # the stacked norm scale is 2-D and still not decayed
    names = dict(zip([p for p, _ in flatten_with_path(g_np)], tmask))
    assert names["layers/ln1/scale"] == 0.0 and names["ln_f/scale"] == 0.0
    assert names["layers/attn/wq"] == 1.0
