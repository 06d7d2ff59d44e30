"""Port parity for GQA flash attention (kernel B5): the wrapper's plain twin
against the Pallas kernel ``flash_attention_pallas`` in interpret mode, and
the port's oracle against the reference's, on the same numpy inputs.

The reference has two causal masks (its kernel top-left, its oracle
bottom-right); they agree only at Sq == Sk.  The twin is held to the
Pallas kernel at Sq == Sk and Sq != Sk, the port's oracle to the
reference's oracle at Sq != Sk.  Tolerances follow
``tests/test_kernels.py:28``: f32 at 5e-5, bf16 at 5e-2 abs with 1e-2
relative (the twin rounds once, from f32, the Pallas kernel too, but the
two sum in other orders)."""
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_prefill.flash_prefill import \
    flash_attention_pallas  # noqa: E402
from repro.kernels.flash_prefill.flash_prefill import \
    precheck as j_precheck  # noqa: E402
from repro.kernels.flash_prefill.ref import \
    flash_attention_reference as j_reference  # noqa: E402
from repro_torch.kernels.flash_prefill import flash_prefill as fpk  # noqa: E402
from repro_torch.kernels.flash_prefill.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_prefill.ref import (  # noqa: E402
    flash_attention_plain, flash_attention_reference)

DTYPES = {"f32": (np.float32, torch.float32, jnp.float32),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16, jnp.bfloat16)}
TOL = {"f32": dict(atol=5e-5, rtol=0), "bf16": dict(atol=5e-2, rtol=1e-2)}


def _inputs(kind, B, Sq, Sk, H, Kv, dh, seed=2):
    rng = np.random.default_rng(seed)
    npdt = DTYPES[kind][0]
    return (rng.standard_normal((B, Sq, H, dh)).astype(npdt),
            rng.standard_normal((B, Sk, Kv, dh)).astype(npdt),
            rng.standard_normal((B, Sk, Kv, dh)).astype(npdt))


def _torch(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16 if x.dtype == ml_dtypes.bfloat16 else torch.float32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Sk,H,Kv,dh,bq,bk", [
    (1, 32, 32, 2, 2, 16, 16, 16),
    (2, 64, 64, 4, 2, 32, 16, 32),     # GQA + rectangular blocks
    (1, 48, 48, 6, 1, 16, 16, 16),     # MQA-ish, non-pow2 seq
    (1, 32, 48, 4, 2, 16, 16, 16),     # Sq != Sk: the kernel's top-left mask
    (1, 48, 32, 4, 2, 16, 16, 16),     # more queries than keys
])
def test_twin_matches_pallas_kernel(kind, B, Sq, Sk, H, Kv, dh, bq, bk):
    q, k, v = _inputs(kind, B, Sq, Sk, H, Kv, dh)
    jdt = DTYPES[kind][2]
    want = flash_attention_pallas(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                  jnp.asarray(v, jdt), causal=True,
                                  block_q=bq, block_k=bk, interpret=True)
    got = flash_attention(_torch(q), _torch(k), _torch(v), causal=True,
                          block_q=bq, block_k=bk)
    assert got.dtype == DTYPES[kind][1] and got.shape == (B, Sq, H, dh)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[kind])
    # the plain twin is what the wrapper runs on the CPU
    assert torch.equal(got, flash_attention_plain(_torch(q), _torch(k),
                                                  _torch(v), True))


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_twin_matches_pallas_kernel_noncausal(kind):
    q, k, v = _inputs(kind, 1, 32, 48, 4, 2, 16, seed=3)
    jdt = DTYPES[kind][2]
    want = flash_attention_pallas(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                  jnp.asarray(v, jdt), causal=False,
                                  block_q=16, block_k=16, interpret=True)
    got = flash_attention(_torch(q), _torch(k), _torch(v), causal=False,
                          block_q=16, block_k=16)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[kind])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk", [(32, 48), (48, 48)])
def test_oracle_matches_reference_oracle(causal, Sq, Sk):
    """The port's oracle keeps the reference oracle's bottom-right mask; at
    Sq != Sk it differs from the kernel's top-left mask."""
    q, k, v = _inputs("f32", 2, Sq, Sk, 4, 2, 16, seed=4)
    want = j_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal)
    got = flash_attention_reference(_torch(q), _torch(k), _torch(v), causal)
    np.testing.assert_allclose(_np(got), _np(want), atol=5e-5)
    top_left = flash_attention_plain(_torch(q), _torch(k), _torch(v), causal)
    assert torch.equal(top_left, got) == (Sq == Sk or not causal)


@pytest.mark.parametrize("shape", [
    dict(B=1, H=4, Kv=2, Sq=64, Sk=64, dh=16, block_q=16, block_k=32),
    dict(B=1, H=6, Kv=4, Sq=48, Sk=40, dh=16, block_q=32, block_k=16),
])
def test_precheck_errors_match_reference(shape):
    """The same divisibility and head-group errors as the TPU kernel's
    precheck (the VMEM budget becomes a shared-memory budget, which no
    small shape exceeds)."""
    want = j_precheck(**shape)["errors"]
    got = fpk.precheck(**shape)
    assert got["errors"] == want
    assert got["smem_bytes"] <= fpk.SMEM_PER_BLOCK
    q, k, v = (torch.zeros(1, shape["Sq"], shape["H"], 16),
               torch.zeros(1, shape["Sk"], shape["Kv"], 16),
               torch.zeros(1, shape["Sk"], shape["Kv"], 16))
    if want:
        with pytest.raises(ValueError, match="not divisible"):
            flash_attention(q, k, v, block_q=shape["block_q"],
                            block_k=shape["block_k"])


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k = torch.zeros(1, 16, 4, 160), torch.zeros(1, 16, 2, 160)
    with pytest.raises(ValueError, match="dh=160"):
        flash_attention(q, k, k)
    with pytest.raises(TypeError, match="dtypes"):
        flash_attention(torch.zeros(1, 16, 4, 16),
                        torch.zeros(1, 16, 2, 16, dtype=torch.bfloat16),
                        torch.zeros(1, 16, 2, 16, dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# The bf16 kernel's numerics, emulated in plain torch: q, k and v are bf16
# operands (exact), S = q.k^T accumulates in f32 over tiles of 64 keys with
# the online softmax in f32 on log2-scaled scores, P is split into P_hi +
# P_lo bf16 for two P.V products accumulated in f32, l sums the f32 P, and
# o = acc / max(l, 1e-30) is rounded once to bf16.  It must agree with the
# plain twin within chip_smoke.py's one bf16 step (1e-3 abs + 2^-7 |want|);
# with P_hi alone it misses that step on causal rows that see few keys.
# The f32 instance multiplies in f32 on CUDA cores: its emulation is the f32
# operands themselves, held to 2e-5.
# ---------------------------------------------------------------------------

KEY_TILE = fpk.TILES[torch.bfloat16][1]
BF16_ATOL, BF16_RTOL = 1e-3, 2 ** -7              # chip_smoke.py's bf16 check


def _emulate_flash_kernel(q, k, v, causal, split=True):
    B, Sq, H, dh = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    qf = q.float().permute(0, 2, 1, 3)                       # [B, H, Sq, dh]
    kf = k.float().repeat_interleave(G, 2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(G, 2).permute(0, 2, 1, 3)
    bf16 = q.dtype == torch.bfloat16
    scale = (math.log2(math.e) if bf16 else 1.0) / math.sqrt(dh)
    exp = torch.exp2 if bf16 else torch.exp
    m = torch.full((B, H, Sq), -1e30)
    l, o = torch.zeros(B, H, Sq), torch.zeros(B, H, Sq, dh)
    pos = torch.arange(Sq)
    for t0 in range(0, Sk, KEY_TILE):
        keys = torch.arange(t0, min(t0 + KEY_TILE, Sk))
        s = qf @ kf[:, :, keys].transpose(-1, -2) * scale
        ok = keys[None] <= pos[:, None] if causal else torch.ones(
            Sq, len(keys), dtype=torch.bool)
        s = torch.where(ok, s, torch.tensor(-1e30))
        mx = torch.maximum(m, s.amax(-1))
        corr = exp(m - mx)
        p = torch.where(ok, exp(s - mx[..., None]), torch.tensor(0.))
        l = l * corr + p.sum(-1)
        parts = [p]
        if bf16:
            hi = p.bfloat16().float()
            parts = [hi, (p - hi).bfloat16().float()] if split else [hi]
        o = o * corr[..., None] + sum(x @ vf[:, :, keys] for x in parts)
        m = mx
    out = o / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _one_step_ratio(got, want):
    """max of |got - want| / (1e-3 + 2^-7 |want|): <= 1 is one bf16 step."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / (BF16_ATOL + BF16_RTOL * want.abs())).max()


EMU_SHAPES = [
    (1, 128, 128, 4, 2, 64),       # G = 2, two key tiles
    (1, 200, 200, 8, 8, 32),       # G = 1, ragged tile
    (1, 96, 160, 6, 1, 16),        # G = 6, Sq < Sk
    (1, 160, 96, 4, 2, 40),        # Sq > Sk, dh not a multiple of 16
]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", EMU_SHAPES)
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_kernel_numerics_scheme_meets_chip_tolerance(kind, shape, causal):
    q, k, v = (_torch(x) for x in _inputs(kind, *shape, seed=5))
    got = _emulate_flash_kernel(q, k, v, causal)
    want = flash_attention_plain(q, k, v, causal)
    assert got.dtype == want.dtype
    if kind == "f32":
        assert (got - want).abs().max() <= 2e-5
    else:
        assert _one_step_ratio(got, want) <= 1.0


def test_kernel_numerics_need_the_p_split():
    """P rounded once to bf16 misses one bf16 step on the causal rows that
    see few keys (at the bench's dh = 128, G = 4)."""
    q, k, v = (_torch(x) for x in _inputs("bf16", 1, 256, 256, 8, 2, 128,
                                          seed=0))
    want = flash_attention_plain(q, k, v, True)
    assert _one_step_ratio(_emulate_flash_kernel(q, k, v, True), want) <= 1
    assert _one_step_ratio(_emulate_flash_kernel(q, k, v, True, split=False),
                           want) > 1


@pytest.mark.parametrize("dh", [16, 20, 40, 64, 100, 128])
def test_precheck_budget_of_each_instance(dh):
    """bf16: 128 q rows and a ring of two K and V tiles of 64 keys, every
    tile 128 columns wide whatever dh (zero-padded, which is exact, so any
    dh <= 128 is accepted), plus 1 KB of alignment; f32: the f32 tiles."""
    shape = dict(B=1, H=4, Kv=2, Sq=64, Sk=64, dh=dh)
    got = fpk.precheck(**shape)
    assert got["errors"] == []
    assert got["smem_bytes"] == 1024 + (128 + 2 * 2 * 64) * 128 * 2 == 99_328
    f32 = fpk.precheck(**shape, dtype=torch.float32)
    assert f32["errors"] == []
    assert f32["smem_bytes"] == 4 * (64 * (dh + 4) + 2 * 32 * (dh + 1)
                                     + 64 * 33)
    assert max(got["smem_bytes"], f32["smem_bytes"]) <= fpk.SMEM_PER_BLOCK
