"""Port parity for winnowing and the slab hybrid cache: the same numpy
inputs through ``repro.core.winnow`` / ``repro.core.hybrid_cache`` and their
ports.  Indices must be equal bit for bit (ties included); at float32 the
values, scales and whole caches after prefill and decode inserts too."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import SwanConfig as JSwan  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core import hybrid_cache as jhc  # noqa: E402
from repro.core import winnow as jw  # noqa: E402
from repro_torch.configs import SwanConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core import hybrid_cache as hc  # noqa: E402
from repro_torch.core import winnow as tw  # noqa: E402


def _bits(x) -> np.ndarray:
    """Raw bytes of an array or tensor (compares fp8 and NaN exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x
        return x.numpy().view(np.uint8)
    return np.asarray(x).view(np.uint8)


def _assert_tree_equal(j_tree, t_tree, path=""):
    if isinstance(j_tree, dict):
        assert set(j_tree) == set(t_tree), path
        for k in j_tree:
            _assert_tree_equal(j_tree[k], t_tree[k], f"{path}/{k}")
        return
    np.testing.assert_array_equal(_bits(j_tree), _bits(t_tree), err_msg=path)


@pytest.mark.parametrize("k_active", [None, 4])
def test_topk_pack_ties_bit_equal(k_active):
    rng = np.random.default_rng(0)
    # small integers: many exact magnitude ties, signs differ (|-2| == |2|)
    x = rng.integers(-3, 4, (2, 3, 5, 16)).astype(np.float32)
    jv, ji = jw.topk_pack(jnp.asarray(x), 6, k_active)
    tv, ti = tw.topk_pack(torch.from_numpy(x), 6, k_active)
    assert ti.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


def test_quantize_int8_and_fp8_cast_equal():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 7, 9)) * 3).astype(np.float32)
    jq, js = jw.quantize_int8(jnp.asarray(x))
    tq, ts = tw.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    # fp8: includes values past e4m3's range (the reference casts to NaN)
    y = np.concatenate([x.ravel(), [448.0, 460.0, 464.0, 470.0, -500.0,
                                    1e-9, 0.0]]).astype(np.float32)
    j8 = jnp.asarray(y).astype(jnp.float8_e4m3fn)
    np.testing.assert_array_equal(_bits(j8), _bits(tw.cast_fp8_e4m3(
        torch.from_numpy(y))))


@pytest.mark.parametrize("mode, quant", [("topk", None), ("topk", "int8"),
                                         ("topk", "fp8"), ("truncate", None)])
def test_winnow_vector_equal(mode, quant):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 2, 5, 16)).astype(np.float32)
    kw = dict(k_max=6, buffer=4, mode=mode, quantize=quant is not None,
              quant_dtype=quant or "int8", k_value=3)
    for which in ("k", "v"):
        j = jw.winnow_vector(jnp.asarray(x), JSwan(**kw), which)
        t = tw.winnow_vector(torch.from_numpy(x), SwanConfig(**kw), which)
        _assert_tree_equal(j, t)


def _cfgs():
    return (j_smoke("llama3-8b").replace(dtype="float32", param_dtype="float32"),
            get_smoke_config("llama3-8b").replace(dtype="float32",
                                                  param_dtype="float32"))


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("S", [13, 3])          # S > b and S < b
def test_prefill_then_decode_inserts_bit_equal(S, quant):
    jcfg, tcfg = _cfgs()
    kw = dict(k_max=8, buffer=4, quantize=quant is not None,
              quant_dtype=quant or "int8")
    jswan, tswan = JSwan(**kw), SwanConfig(**kw)
    B, Kv, dh, max_seq = 3, jcfg.n_kv_heads, jcfg.d_head, 32
    rng = np.random.default_rng(3)
    kh = rng.standard_normal((B, S, Kv, dh)).astype(np.float32)
    vh = rng.standard_normal((B, S, Kv, dh)).astype(np.float32)

    jc = jhc.swan_cache_insert_prefill(jhc.init_swan_cache(jcfg, jswan, B, max_seq),
                                       jswan, jcfg, jnp.asarray(kh),
                                       jnp.asarray(vh), k_act=jswan.kk)
    tc = hc.init_swan_cache(tcfg, tswan, B, max_seq, "cpu")
    hc.swan_cache_insert_prefill_(tc, tswan, torch.from_numpy(kh),
                                  torch.from_numpy(vh), k_act=tswan.kk)
    _assert_tree_equal(jc, tc, "prefill")

    # decode: lockstep-style steps plus a dead lane (pos < 0) in the middle
    for step in range(7):
        pos = np.asarray([S + step, -1, S + step], np.int32)
        kd = rng.standard_normal((B, 1, Kv, dh)).astype(np.float32)
        vd = rng.standard_normal((B, 1, Kv, dh)).astype(np.float32)
        jc = jhc.swan_cache_insert_decode(jc, jswan, jcfg, jnp.asarray(kd),
                                          jnp.asarray(vd), jnp.asarray(pos))
        hc.swan_cache_insert_decode_(tc, tswan, torch.from_numpy(kd),
                                     torch.from_numpy(vd),
                                     torch.from_numpy(pos))
        _assert_tree_equal(jc, tc, f"decode step {step}")
    np.testing.assert_array_equal(
        np.asarray(jhc.sparse_len(jswan, jnp.asarray(pos))),
        hc.sparse_len(tswan, torch.from_numpy(pos)).numpy())


def test_cache_byte_accounting_equal():
    jcfg, tcfg = _cfgs()
    for kw in (dict(k_max=8, buffer=4), dict(k_max=8, buffer=4, quantize=True),
               dict(k_max=8, buffer=4, quantize=True, quant_dtype="fp8"),
               dict(k_max=8, buffer=4, mode="truncate")):
        assert (hc.packed_vector_bytes(tcfg, SwanConfig(**kw))
                == jhc.packed_vector_bytes(jcfg, JSwan(**kw)))
        assert (hc.cache_bytes(tcfg, SwanConfig(**kw), 2, 64)
                == jhc.cache_bytes(jcfg, JSwan(**kw), 2, 64))
    assert hc.dense_cache_bytes(tcfg, 2, 64) == jhc.dense_cache_bytes(jcfg, 2, 64)
    # a cache allocated by the port has the bytes the accounting says
    swan = SwanConfig(k_max=8, buffer=4, quantize=True)
    cache = hc.init_swan_cache(tcfg, swan, 2, 64, "cpu")
    leaves = [cache["k"], cache["v"]]
    n = sum(t.numel() * t.element_size() for s in leaves for t in s.values())
    n += sum(cache[k].numel() * cache[k].element_size()
             for k in ("buf_k", "buf_v"))
    assert n == hc.cache_bytes(tcfg, swan, 2, 64)


def test_convert_keeps_nesting_and_bits():
    rng = np.random.default_rng(4)
    tree = {"a": {"b": jnp.asarray(rng.standard_normal((2, 3)), jnp.bfloat16)},
            "c": [jnp.asarray(rng.standard_normal(4)).astype(jnp.float8_e4m3fn),
                  jnp.arange(5, dtype=jnp.int32)]}
    t = to_torch(tree, device="cpu")
    assert t["a"]["b"].dtype == torch.bfloat16
    assert t["c"][0].dtype == torch.float8_e4m3fn
    assert t["c"][1].dtype == torch.int32
    np.testing.assert_array_equal(_bits(np.asarray(tree["a"]["b"])),
                                  _bits(t["a"]["b"].view(torch.int16)))
    np.testing.assert_array_equal(_bits(np.asarray(tree["c"][0])),
                                  _bits(t["c"][0]))
