"""Port parity for fused winnowing (kernel B6): the wrapper's plain twin
against the Pallas kernel ``swan_prune_pallas`` (interpret mode) and the
reference oracle ``swan_prune_reference``, on the same numpy inputs and the
same random orthogonal rotation.

Indices must equal exactly (the selection order is descending |x̂| with
ties to the lowest index on both sides); values follow
``tests/test_kernels.py:28``: 5e-5 at f32, 5e-2 at bf16."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.projections import random_orthogonal  # noqa: E402
from repro.kernels.swan_prune.ref import \
    swan_prune_reference as j_reference  # noqa: E402
from repro.kernels.swan_prune.swan_prune import swan_prune_pallas  # noqa: E402
from repro_torch.core.winnow import rotate_k, topk_pack  # noqa: E402
from repro_torch.kernels.swan_prune import swan_prune as spk  # noqa: E402
from repro_torch.kernels.swan_prune.ops import swan_prune  # noqa: E402

DTYPES = {"f32": (np.float32, torch.float32, jnp.float32),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16, jnp.bfloat16)}
TOL = {"f32": 5e-5, "bf16": 5e-2}


def _inputs(kind, B, Kv, S, dh):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, Kv, S, dh)).astype(DTYPES[kind][0])
    P = np.array(random_orthogonal(jax.random.PRNGKey(0), (Kv,), dh),
                 np.float32)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(DTYPES[kind][1])
    return x, P, xt, torch.from_numpy(P)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("B,Kv,S,dh,k,tile", [
    (1, 2, 16, 16, 4, 8),
    (2, 2, 32, 32, 12, 16),
])
def test_twin_matches_pallas_and_reference(kind, B, Kv, S, dh, k, tile):
    x, P, xt, Pt = _inputs(kind, B, Kv, S, dh)
    jx = jnp.asarray(x, DTYPES[kind][2])
    vk, ik = swan_prune_pallas(jx, jnp.asarray(P), k, tile=tile,
                               interpret=True)
    vr, ir = j_reference(jx, jnp.asarray(P), k)
    vals, idx = swan_prune(xt, Pt, k, tile=tile)
    assert vals.dtype == DTYPES[kind][1] and idx.dtype == torch.int8
    assert vals.shape == idx.shape == (B, Kv, S, k)
    for want_v, want_i in ((vk, ik), (vr, ir)):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(vals.float().numpy(),
                                   np.asarray(want_v, np.float32),
                                   atol=TOL[kind])


def test_twin_equals_the_serve_path_winnow():
    """At f32 the fused twin packs exactly what the serve path's
    ``topk_pack(rotate_k(...))`` packs."""
    _, _, xt, Pt = _inputs("f32", 2, 2, 32, 32)
    vals, idx = swan_prune(xt, Pt, 12)
    rv, ri = topk_pack(rotate_k(xt.transpose(1, 2), Pt).transpose(1, 2), 12)
    assert torch.equal(idx, ri)
    torch.testing.assert_close(vals, rv, atol=1e-6, rtol=0)


def test_ties_go_to_the_lowest_index():
    """Equal magnitudes (a signed permutation of repeated values) pack in
    ascending index order, as lax.top_k and the TPU kernel's arg-max."""
    x = torch.tensor([[[[1.0, -2.0, 2.0, 1.0, -1.0, 0.5, 2.0, 0.0]]]])
    vals, idx = swan_prune(x, torch.eye(8)[None], 5)
    assert idx.flatten().tolist() == [1, 2, 6, 0, 3]
    assert vals.flatten().tolist() == [-2.0, 2.0, 2.0, 1.0, 1.0]
    jv, ji = swan_prune_pallas(jnp.asarray(x.numpy()), jnp.eye(8)[None], 5,
                               tile=1, interpret=True)
    assert np.asarray(ji).flatten().tolist() == [1, 2, 6, 0, 3]


def test_precheck_refuses_what_the_kernel_does_not_take():
    assert spk.precheck(dh=128, k_max=64)["errors"] == []
    assert spk.precheck(dh=128, k_max=64)["smem_bytes"] <= spk.SMEM_PER_BLOCK
    assert any("dh=256" in e for e in spk.precheck(dh=256, k_max=8)["errors"])
    for k in (0, 17):
        assert spk.precheck(dh=16, k_max=k)["errors"]
    x, P = torch.zeros(1, 1, 24, 16), torch.eye(16)[None]
    with pytest.raises(ValueError, match="k_max=17"):
        swan_prune(x, P, 17)
    with pytest.raises(ValueError, match="not divisible by tile"):
        swan_prune(x, P, 4, tile=16)
