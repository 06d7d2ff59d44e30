"""Port parity for the dense transformer on the llama3-8b smoke config: the
reference's JAX-initialised weights carried across, logits and calibration
captures compared at float32 (5e-5) and bfloat16 (5e-2); SWAN projections
compared by invariants, since ``eigh`` fixes no eigenvector sign."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core import projections as jproj  # noqa: E402
from repro.launch.io import make_batch as j_make_batch  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.runtime.serve_loop import calibrate_swan as j_calibrate  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core import projections as tproj  # noqa: E402
from repro_torch.launch.io import make_batch  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.mlp import mlp_forward  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.runtime.serve_loop import calibrate_swan  # noqa: E402

TOL = {"float32": 5e-5, "bfloat16": 5e-2}


def _pair(dtype: str):
    jcfg = j_smoke("llama3-8b").replace(dtype=dtype, param_dtype=dtype)
    tcfg = get_smoke_config("llama3-8b").replace(dtype=dtype, param_dtype=dtype)
    japi = j_get_model(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, japi, jparams, to_torch(jparams, device="cpu")


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def f32():
    return _pair("float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_forward_logits(dtype):
    jcfg, tcfg, japi, jparams, tparams = _pair(dtype)
    jb = j_make_batch(jcfg, 2, 24, seed=1)
    tb = make_batch(tcfg, 2, 24, seed=1, device="cpu")
    np.testing.assert_array_equal(np.asarray(jb["tokens"]), tb["tokens"].numpy())
    jl, _ = japi.forward(jparams, jcfg, jb)
    tl = get_model(tcfg).forward(tparams, tcfg, tb)
    assert tl.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=TOL[dtype])


@pytest.mark.parametrize("act", ["silu", "gelu", "relu_sq"])
def test_init_layout_and_mlp_match(act):
    """The port's init has the reference's tree (names, shapes, dtypes),
    and its MLP (SwiGLU for silu, two matrices otherwise) the reference's
    output on the same weights."""
    jcfg = j_smoke("llama3-8b").replace(dtype="float32", param_dtype="float32",
                                        act=act)
    tcfg = get_smoke_config("llama3-8b").replace(dtype="float32",
                                                 param_dtype="float32", act=act)
    jparams = j_get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    tparams = get_model(tcfg).init_params(tcfg, 0, "cpu")
    j_leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(j_leaves) == len(jax.tree_util.tree_leaves(tparams))
    for path, leaf in j_leaves:
        t = tparams
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape and str(t.dtype) == f"torch.{leaf.dtype}"
    lp = jax.tree_util.tree_map(lambda x: np.asarray(x[0]), jparams["layers"]["mlp"])
    x = np.random.default_rng(6).standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    want = jmlp.mlp_forward(lp, jcfg, jnp.asarray(x))
    got = mlp_forward(to_torch(lp, device="cpu"), tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


@pytest.mark.parametrize("kind", ["dense", "blocked"])
def test_causal_attention_matches(kind):
    rng = np.random.default_rng(8)
    B, S, H, Kv, dh = 2, 20, 4, 2, 16
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, Kv, dh)).astype(np.float32) for _ in range(2))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    if kind == "dense":
        want = jattn.dense_attention(jq, jk, jv, None, True)
        got = tattn.dense_attention(tq, tk, tv, True)
    else:               # blocks of 8 keys: 3 blocks, a ragged last one
        want = jattn.blocked_attention(jq, jk, jv, True, block=8)
        got = tattn.blocked_attention(tq, tk, tv, True, block=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


def test_collect_qkv(f32):
    jcfg, tcfg, japi, jparams, tparams = f32
    j = japi.collect_qkv(jparams, jcfg, j_make_batch(jcfg, 2, 16, seed=3))
    t = get_model(tcfg).collect_qkv(tparams, tcfg,
                                    make_batch(tcfg, 2, 16, seed=3, device="cpu"))
    for a, b in zip(j, t):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(_f32(b), _f32(a), atol=5e-5)


def test_gram_basis_matches_up_to_sign_on_gapped_spectrum():
    """A calibration matrix with well-separated singular values: every
    eigenvector is determined up to sign, so |P| must match column by
    column and the eigenvalues exactly (to f32 rounding)."""
    rng = np.random.default_rng(5)
    d, n = 16, 200
    u, _ = np.linalg.qr(rng.standard_normal((n, d)))
    v, _ = np.linalg.qr(rng.standard_normal((d, d)))
    sigma = 1.5 ** -np.arange(d, dtype=np.float64) * 50
    s = (u * sigma) @ v.T
    s = np.stack([s, s[::-1] * 0.5]).astype(np.float32)          # [2, n, d]
    jp, je = jax.vmap(jproj.gram_basis_eigs)(jnp.asarray(s))
    tp, te = tproj.gram_basis_eigs(torch.from_numpy(s))
    assert tproj.check_orthogonal(tp) < 1e-5
    # f32 eigenvalues carry ~eps·λ_max absolute error
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-4,
                               atol=1e-6 * float(je.max()))
    lead = 8     # columns whose eigen-gaps dwarf that error
    signs = np.sign(np.sum(np.asarray(jp) * tp.numpy(), axis=-2))
    np.testing.assert_allclose((tp.numpy() * signs[:, None, :])[..., :lead],
                               np.asarray(jp)[..., :lead], atol=1e-3)


def test_calibration_invariants_and_absorbed_logits(f32):
    jcfg, tcfg, japi, jparams, tparams = f32
    api = get_model(tcfg)
    tpj = calibrate_swan(api, tcfg, tparams,
                         make_batch(tcfg, 2, 24, seed=3, device="cpu"))
    jpj = j_calibrate(japi, jcfg, jparams, j_make_batch(jcfg, 2, 24, seed=3))
    L, Kv, dh = tcfg.n_layers, tcfg.n_kv_heads, tcfg.d_head
    for name in ("p_qk", "p_vo"):
        assert tuple(tpj[name].shape) == (L, Kv, dh, dh)
        assert tproj.check_orthogonal(tpj[name]) < 1e-4
        # spectra are basis-free: they must agree
        spec = name.replace("p_", "spectrum_")
        np.testing.assert_allclose(tpj[spec].numpy(), np.asarray(jpj[spec]),
                                   rtol=1e-3, atol=1e-3)
    # absorbing the port's projections is lossless (Lemma A.2), and absorbing
    # the reference's projections in the port gives the reference's weights
    tb = make_batch(tcfg, 2, 20, seed=9, device="cpu")
    dense = api.forward(tparams, tcfg, tb)
    own = api.forward(api.absorb(tparams, tcfg, tpj), tcfg, tb)
    np.testing.assert_allclose(own.numpy(), dense.numpy(), atol=5e-5)
    j_abs = japi.absorb(jparams, jcfg, jpj)
    t_abs = api.absorb(tparams, tcfg, to_torch(jpj, device="cpu"))
    for n in ("wv", "wo"):
        np.testing.assert_allclose(t_abs["layers"]["attn"][n].numpy(),
                                   np.asarray(j_abs["layers"]["attn"][n]),
                                   atol=5e-5)
