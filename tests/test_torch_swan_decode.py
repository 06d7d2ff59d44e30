"""Port parity for the SWAN decode read (kernel B1): the kernel wrapper's
plain twin and the port's gather/scatter path against the JAX oracle
``swan_decode_reference`` and the Pallas kernel in interpret mode, on the
same numpy inputs.  Tolerances follow tests/test_kernels.py: 5e-5 where
the arithmetic is float32 (f32, int8+scale and fp8 values with f32 q), 5e-2
where it is bfloat16 — which includes the pure paths over fp8 values: they
widen fp8 to bf16 and gather q̂ in that dtype (the reference does the
same, so port and reference pure paths still agree at 5e-5)."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import SwanConfig as JSwan  # noqa: E402
from repro.core.swan_attention import swan_decode_attention as j_attention  # noqa: E402
from repro.kernels.swan_decode.ref import swan_decode_reference as j_reference  # noqa: E402
from repro.kernels.swan_decode.swan_decode import swan_decode_pallas  # noqa: E402
from repro_torch.configs import SwanConfig  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core.swan_attention import swan_decode_attention  # noqa: E402
from repro_torch.kernels.swan_decode.swan_decode import (  # noqa: E402
    INSTANCES, KERNEL, g_plan, precheck, run_grouped, swan_decode,
    swan_decode_plain, smem_bytes, workspace_bytes)

B, KV, G, DH, S, K, BUF, BS = 2, 2, 2, 16, 32, 8, 8, 16

# value storage -> (q/ring dtype, oracle tolerance, pure-path tolerance)
VALS = {
    "f32": (np.float32, 5e-5, 5e-5),
    "bf16": (ml_dtypes.bfloat16, 5e-2, 5e-2),
    "int8": (np.float32, 5e-5, 5e-5),
    "fp8": (np.float32, 5e-5, 5e-2),
}
# decode positions per sequence: ring wrapped with staggered positions, an
# empty sparse prefix with a partly filled ring, a full-length prefix
CASES = {
    "wrap": [S + BUF - 4, 20],
    "empty_prefix": [5, 2],
    "full_prefix": [S + BUF - 1, S + BUF - 1],
}


def _inputs(vals_kind: str, case: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    qdt = VALS[vals_kind][0]
    pos = np.asarray(CASES[case], np.int32)
    sp_len = np.maximum(pos + 1 - BUF, 0).astype(np.int32)
    buf_pos = np.full((B, BUF), -1, np.int32)
    for bi, p in enumerate(pos):
        for t in range(max(p - BUF + 1, 0), p + 1):
            buf_pos[bi, t % BUF] = t
    idx = lambda: np.stack([rng.permutation(DH)[:K] for _ in range(B * KV * S)]
                           ).reshape(B, KV, S, K).astype(np.int8)
    a = {"q": rng.standard_normal((B, KV, G, DH)).astype(qdt),
         "k_idx": idx(), "v_idx": idx(),
         "buf_k": rng.standard_normal((B, KV, BUF, DH)).astype(qdt),
         "buf_v": rng.standard_normal((B, KV, BUF, DH)).astype(qdt),
         "buf_pos": buf_pos, "pos": pos, "sp_len": sp_len}
    if vals_kind == "int8":
        for s in "kv":
            a[f"{s}_vals"] = rng.integers(-127, 128, (B, KV, S, K)).astype(np.int8)
            a[f"{s}_scale"] = (rng.random((B, KV, S)) * 0.1 + 0.01).astype(np.float32)
    else:
        vdt = ml_dtypes.float8_e4m3fn if vals_kind == "fp8" else qdt
        for s in "kv":
            a[f"{s}_vals"] = rng.standard_normal((B, KV, S, K)).astype(vdt)
    return a


ARGS = ("q", "k_vals", "k_idx", "v_vals", "v_idx", "buf_k", "buf_v",
        "buf_pos", "pos", "sp_len")


def _jax_outputs(a):
    j = {n: jnp.asarray(v) for n, v in a.items()}
    args = [j[n] for n in ARGS]
    kw = {"k_scale": j.get("k_scale"), "v_scale": j.get("v_scale")}
    ref = j_reference(*args, **kw)
    pal = swan_decode_pallas(*args, **kw, block_s=BS, interpret=True)
    return (np.asarray(ref, np.float32), np.asarray(pal, np.float32))


def _cache(a, conv):
    """One layer's hybrid-cache dict over the inputs, leaves through conv."""
    cache = {n: conv(a[n]) for n in ("buf_k", "buf_v", "buf_pos")}
    for s in "kv":
        cache[s] = {n: conv(a[f"{s}_{n}"]) for n in ("vals", "idx", "scale")
                    if f"{s}_{n}" in a}
    return cache


def _swan(kind, cls):
    return cls(k_max=K, buffer=BUF, quantize=kind in ("int8", "fp8"),
               quant_dtype="fp8" if kind == "fp8" else "int8")


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("vals_kind", list(VALS))
def test_plain_twin_and_pure_path_match_jax(vals_kind, case):
    a = _inputs(vals_kind, case)
    _, tol, pure_tol = VALS[vals_kind]
    ref, pal = _jax_outputs(a)
    np.testing.assert_allclose(pal, ref, atol=tol)      # the oracles agree

    t = to_torch(a, device="cpu")
    launches = KERNEL.launches
    twin = swan_decode(*[t[n] for n in ARGS], k_scale=t.get("k_scale"),
                       v_scale=t.get("v_scale"))
    assert KERNEL.launches == launches           # CPU tensors never launch
    assert twin.dtype == t["q"].dtype and twin.shape == (B, KV, G, DH)
    pure = swan_decode_attention(t["q"], _cache(t, lambda x: x),
                                 _swan(vals_kind, SwanConfig), t["pos"])
    for got, atol in ((twin, tol), (pure, pure_tol)):
        got = got.float().numpy()
        np.testing.assert_allclose(got, ref, atol=atol)
        np.testing.assert_allclose(got, pal, atol=atol)
    # the port's pure path and the reference's pure path on one cache
    j_pure = j_attention(jnp.asarray(a["q"]), _cache(a, jnp.asarray),
                         _swan(vals_kind, JSwan), None, jnp.asarray(a["pos"]))
    np.testing.assert_allclose(pure.float().numpy(),
                               np.asarray(j_pure, np.float32), atol=tol)


def _good():
    return to_torch(_inputs("bf16", "wrap"), device="cpu")


@pytest.mark.parametrize("mutate, err", [
    (lambda t: t.update(q=t["q"].half()), TypeError),
    (lambda t: t.update(k_vals=t["k_vals"].float(), v_vals=t["v_vals"].float()),
     TypeError),
    (lambda t: t.update(k_idx=t["k_idx"].long()), TypeError),
    (lambda t: t.update(buf_pos=t["buf_pos"][:, :-1]), ValueError),
    (lambda t: t.update(k_vals=t["k_vals"][..., :-1]), ValueError),
    (lambda t: t.update(buf_k=t["buf_k"].transpose(2, 3).contiguous()
                        .transpose(2, 3)), ValueError),
    (lambda t: t.update(k_vals=t["k_vals"].to(torch.int8),
                        v_vals=t["v_vals"].to(torch.int8)), TypeError),
])
def test_wrapper_rejects_bad_operands(mutate, err):
    t = _good()
    mutate(t)
    with pytest.raises(err):
        swan_decode(*[t[n] for n in ARGS], k_scale=t.get("k_scale"),
                    v_scale=t.get("v_scale"))


def test_precheck_budget():
    bf = {"v_dtype": torch.bfloat16, "S": 4096}
    ok = precheck(G=4, dh=128, k_max=64, b=128, **bf)
    assert not ok["errors"] and ok["smem_bytes"] < 48 * 1024
    # a G the CUDA source has no instance of runs as the padded plan's
    # instance: G = 3 as one launch of G = 4, G = 7 as one of G = 8, G = 16
    # as two of G = 8; the budget is the instance's, the workspace the
    # groups' together
    for G, inst, groups in ((3, 4, 1), (7, 8, 1), (16, 8, 2)):
        got = precheck(G=G, dh=128, k_max=64, b=128, **bf)
        assert not got["errors"], got
        assert (got["instance"], got["groups"]) == (inst, groups)
        assert got["smem_bytes"] == smem_bytes(inst, 128, 128, 64,
                                               torch.bfloat16)
        assert got["workspace_bytes"] == groups * workspace_bytes(
            1, 1, inst, 128, 4096)
    assert precheck(G=4, dh=256, k_max=64, b=128, **bf)["errors"]
    assert precheck(G=4, dh=64, k_max=65, b=128, **bf)["errors"]
    assert precheck(G=8, dh=128, k_max=64, b=8192, **bf)["errors"]   # > 227 KB


@pytest.mark.parametrize("v_dtype, vb", [
    (torch.float32, 4), (torch.bfloat16, 2), (torch.int8, 1),
    (torch.float8_e4m3fn, 1)])
def test_precheck_budget_of_each_value_type(v_dtype, vb):
    # the serve shape: q^ 2 KB, the warps' dense value rows 16 KB, (m, l)
    # and tile scores, then the largest of two staging buffers of 32 rows
    # (vals, idx, scales of k and v), the ring's scores and the warps'
    # accumulators
    got = precheck(G=4, dh=128, k_max=64, b=128, v_dtype=v_dtype, S=4096)
    stage = 2 * (32 * 64 * vb + 32 * 64 + 32 * 4)
    assert not got["errors"]
    assert got["smem_bytes"] == (2048 + 16384 + 256 + 512
                                 + max(2 * stage, 2048, 16384))
    # the merge block: a max and a weight per split and query, and the ring's
    assert got["merge_smem_bytes"] == 4 * (2 * 16 + 3) * 4
    # 16 prefix splits of 256 rows and the ring, acc [dh][G] + m + l each
    assert got["workspace_bytes"] == 4 * 17 * 4 * 130
    for G in (1, 2, 4):                          # every instance fits, k = dh
        assert not precheck(G=G, dh=128, k_max=128, b=128, v_dtype=v_dtype,
                            S=1 << 20)["errors"]
    # G = 8: the merge block's 4 * (2 * n_split + 3) * 8 bytes cap the
    # splits at 3630 (232416 B); one more row needs a 3631st (232480 B)
    edge = 3630 * 256
    assert not precheck(G=8, dh=128, k_max=128, b=128, v_dtype=v_dtype,
                        S=edge)["errors"]
    for S in (edge + 1, 1 << 20):
        errs = precheck(G=8, dh=128, k_max=128, b=128, v_dtype=v_dtype,
                        S=S)["errors"]
        assert len(errs) == 1 and "merge" in errs[0]
    assert precheck(G=4, dh=128, k_max=64, b=128, v_dtype=v_dtype,
                    S=256 * 65535)["errors"]      # more splits than a grid holds


# G -> (instance, groups, per): pad up to the next instance, or cut G > 8
# into equal groups of consecutive heads
PLANS = {1: (1, 1, 1), 2: (2, 1, 2), 3: (4, 1, 3), 4: (4, 1, 4),
         5: (8, 1, 5), 6: (8, 1, 6), 7: (8, 1, 7), 8: (8, 1, 8),
         9: (8, 2, 5), 12: (8, 2, 6), 13: (8, 2, 7), 16: (8, 2, 8),
         17: (8, 3, 6), 24: (8, 3, 8), 25: (8, 4, 7)}


def test_g_plan():
    for G, plan in PLANS.items():
        assert g_plan(G) == plan, G
    for G in range(1, 130):
        inst, groups, per = g_plan(G)
        assert inst in INSTANCES and per <= inst
        assert (groups - 1) * per < G <= groups * per   # no empty launch
        assert groups == -(-G // 8)
    with pytest.raises(ValueError):
        g_plan(0)


def test_precheck_refuses_no_group_size():
    """The Pallas kernel's precheck has no G limit, and neither has the
    port's: every G >= 1 fits at the serve shapes of every value type."""
    for v_dtype in (torch.float32, torch.bfloat16, torch.int8,
                    torch.float8_e4m3fn):
        for G in range(1, 65):
            for dh, k in ((128, 64), (64, 32), (64, 64)):
                got = precheck(G=G, dh=dh, k_max=k, b=128, v_dtype=v_dtype,
                               S=4096)
                assert not got["errors"], (G, dh, k, v_dtype, got["errors"])


@pytest.mark.parametrize("G", [3, 5, 6, 7, 12, 16])
@pytest.mark.parametrize("vals_kind", list(VALS))
def test_grouped_plan_equals_the_whole_group(vals_kind, G):
    """``run_grouped`` (the padding and grouping the CUDA launch goes
    through) over the plain twin gives the plain twin on the whole group
    within f32 rounding (1e-6: the CPU's einsum sums in an order that
    follows the shape), and the JAX oracle's output within the value
    type's tolerance: the zero rows change no real row."""
    a = _inputs(vals_kind, "wrap")
    rng = np.random.default_rng(G)
    a["q"] = rng.standard_normal((B, KV, G, DH)).astype(VALS[vals_kind][0])
    t = to_torch(a, device="cpu")
    rest = [t[n] for n in ARGS[1:]]
    kw = {"k_scale": t.get("k_scale"), "v_scale": t.get("v_scale")}
    whole = swan_decode_plain(t["q"], *rest, **kw)
    shapes = []

    def one(qg):
        shapes.append(tuple(qg.shape))
        return swan_decode_plain(qg, *rest, **kw)
    grouped = run_grouped(t["q"], one)
    inst, groups, _ = g_plan(G)
    assert shapes == [(B, KV, inst, DH)] * groups
    assert grouped.shape == (B, KV, G, DH) and grouped.dtype == t["q"].dtype
    np.testing.assert_allclose(grouped.float().numpy(),
                               whole.float().numpy(), atol=1e-6, rtol=0)
    j = {n: jnp.asarray(v) for n, v in a.items()}
    ref = j_reference(*[j[n] for n in ARGS], k_scale=j.get("k_scale"),
                      v_scale=j.get("v_scale"))
    np.testing.assert_allclose(grouped.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=VALS[vals_kind][1])
    # the wrapper takes any G on the CPU too (its plain twin)
    assert torch.equal(swan_decode(*[t[n] for n in ARGS], **kw), whole)
