"""Port parity for the paged cache and the chunked-prefill cache mechanics:
the host ``PagePool`` driven through one script on both packages, and the
same numpy caches through ``repro.core.{paged_cache,hybrid_cache}`` and
their ports — equal bit for bit at float32 (int8 indices, values, scales,
rings).  Dead lanes write to the trash page, where colliding writes may
land in any order, so pools are compared on every page but page 0."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import SwanConfig as JSwan  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core import hybrid_cache as jhc  # noqa: E402
from repro.core import paged_cache as jpc  # noqa: E402
from repro.core import swan_attention as jswa  # noqa: E402
from repro.runtime.page_pool import PagePool as JPool  # noqa: E402
from repro.runtime.page_pool import PagePoolExhausted as JExhausted  # noqa: E402
from repro_torch.configs import SwanConfig, get_smoke_config  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core import hybrid_cache as hc  # noqa: E402
from repro_torch.core import paged_cache as pc  # noqa: E402
from repro_torch.core import swan_attention as swa  # noqa: E402
from repro_torch.runtime.page_pool import PagePool, PagePoolExhausted  # noqa: E402

B, KV, DH, K, BUF, PS, NP, SMAX = 3, 2, 16, 8, 4, 4, 16, 32
PG = SMAX // PS


def _np(x):
    """Raw bytes of an array or tensor (compares fp8 and NaN exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x
        return x.numpy().view(np.uint8)
    return np.asarray(x).view(np.uint8)


def _assert_tree_equal(j_tree, t_tree, path="", skip_trash=False):
    if isinstance(j_tree, dict):
        assert set(j_tree) == set(t_tree), path
        for k in j_tree:
            _assert_tree_equal(j_tree[k], t_tree[k], f"{path}/{k}",
                               skip_trash or k == "pool")
        return
    j, t = _np(j_tree), _np(t_tree)
    if skip_trash:
        j, t = j[1:], t[1:]
    np.testing.assert_array_equal(j, t, err_msg=path)


# ---------------------------------------------------------------------------
# host page pool
# ---------------------------------------------------------------------------

def _pool_state(pool):
    return (pool.table.tolist(), [list(f) for f in pool._free],
            pool.n_mapped.tolist(), pool._held.tolist(), pool.live_pages,
            pool.free_pages, pool.held_pages, pool.n_pages, pool.version,
            pool.live_bytes(100), pool.reserved_bytes(100),
            pool.shard_live_pages(0), pool.shard_free_pages(0))


SCRIPT = [("ensure", 0, 9), ("reserve", 1, 3), ("ensure", 1, 4),
          ("ensure", 2, 1), ("free_slot", 0), ("ensure", 3, 13),
          ("ensure", 1, 12), ("ensure", 0, 30), ("grow", 12),
          ("ensure", 0, 30), ("reserve", 2, 2), ("free_slot", 1),
          ("ensure", 2, 20), ("ensure", 1, 40), ("free_slot", 3),
          ("ensure", 1, 40), ("pages_for", 17)]


@pytest.mark.parametrize("n_shards", [1, 2])
def test_page_pool_follows_the_reference_script(n_shards):
    jp, tp = JPool(8, 12, 4, 4, n_shards=n_shards), PagePool(
        8, 12, 4, 4, n_shards=n_shards)
    seen = set()
    for op, *args in SCRIPT:
        out = []
        for pool, exc in ((jp, JExhausted), (tp, PagePoolExhausted)):
            try:
                out.append(("ok", getattr(pool, op)(*args)))
            except exc as e:                  # exhaustion: same message
                out.append(("exhausted", str(e)))
            except ValueError as e:
                out.append(("value", str(e)))
        assert out[0] == out[1], (op, args)
        assert _pool_state(jp) == _pool_state(tp), (op, args)
        tp.check_consistent()
        seen.add(out[0][0])
    assert seen == {"ok", "exhausted"}


def test_page_pool_exhaustion_leaves_state_intact():
    tp, jp = PagePool(4, 8, 2, 4), JPool(4, 8, 2, 4)
    for pool, exc in ((tp, PagePoolExhausted), (jp, JExhausted)):
        pool.ensure(0, 8)
        before = _pool_state(pool)
        with pytest.raises(exc):
            pool.ensure(1, 8)
        pool.free_slot(1)                 # the partial mapping is returned
        assert _pool_state(pool)[:3] == before[:3]
    assert _pool_state(tp) == _pool_state(jp)


# ---------------------------------------------------------------------------
# device-side cache mechanics
# ---------------------------------------------------------------------------

def _cfgs():
    base = dict(dtype="float32", param_dtype="float32", n_kv_heads=KV,
                d_head=DH)
    return j_smoke("llama3-8b").replace(**base), \
        get_smoke_config("llama3-8b").replace(**base)


def _swans(quant):
    kw = dict(k_max=K, buffer=BUF, quantize=quant is not None,
              quant_dtype=quant or "int8")
    return JSwan(**kw), SwanConfig(**kw)


def _random_side(rng, lead, quant):
    side = {"vals": rng.standard_normal((*lead, K)).astype(np.float32),
            "idx": np.stack([rng.permutation(DH)[:K]
                             for _ in range(int(np.prod(lead)))]
                            ).reshape(*lead, K).astype(np.int8)}
    if quant == "int8":
        side["vals"] = rng.integers(-127, 128, side["vals"].shape
                                    ).astype(np.int8)
        side["scale"] = rng.random(lead).astype(np.float32) + 0.01
    return side


def _ring(rng, n, fill_to):
    """Rings whose lane ``i`` holds positions [fill_to[i] - BUF, fill_to[i])."""
    buf_pos = np.full((n, BUF), -1, np.int32)
    for i, f in enumerate(fill_to):
        for t in range(max(f - BUF, 0), f):
            buf_pos[i, t % BUF] = t
    return {"buf_k": rng.standard_normal((n, KV, BUF, DH)).astype(np.float32),
            "buf_v": rng.standard_normal((n, KV, BUF, DH)).astype(np.float32),
            "buf_pos": buf_pos}


def _paged_cache(rng, quant, fill_to):
    return {"pool": {s: _random_side(rng, (NP, KV, PS), quant) for s in "kv"},
            **_ring(rng, B, fill_to)}


def _page_table(rng, n_mapped):
    tab = np.zeros((B, PG), np.int32)
    pages = rng.permutation(np.arange(1, NP))
    used = 0
    for i, m in enumerate(n_mapped):
        tab[i, :m] = pages[used:used + m]
        used += m
    return tab


def _j(tree):
    return {k: _j(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else jnp.asarray(tree)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_paged_insert_decode_bit_equal(quant):
    rng = np.random.default_rng(0)
    jcfg, _ = _cfgs()
    jsw, tsw = _swans(quant)
    pos = np.asarray([2, 13, -1], np.int32)          # ring filling, wrapped, dead
    cache = _paged_cache(rng, quant, [2, 13, 9])
    tab = _page_table(rng, [1, 3, 2])
    k_hat = rng.standard_normal((B, 1, KV, DH)).astype(np.float32)
    v_hat = rng.standard_normal((B, 1, KV, DH)).astype(np.float32)
    k_act = np.asarray([8, 5, 3], np.int32)
    want = jpc.paged_insert_decode(_j(cache), jsw, jcfg, jnp.asarray(k_hat),
                                   jnp.asarray(v_hat), jnp.asarray(pos),
                                   jnp.asarray(tab), k_act=jnp.asarray(k_act))
    t = to_torch(cache, device="cpu")
    pc.paged_insert_decode_(t, tsw, torch.as_tensor(k_hat),
                            torch.as_tensor(v_hat), torch.as_tensor(pos),
                            torch.as_tensor(tab), k_act=torch.as_tensor(k_act))
    _assert_tree_equal(want, t)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_paged_insert_prefill_chunk_bit_equal(quant):
    rng = np.random.default_rng(1)
    jcfg, _ = _cfgs()
    jsw, tsw = _swans(quant)
    S = 8
    start = np.asarray([0, 10, 0], np.int32)           # fresh, resumed, dead
    tlen = np.asarray([7, 8, 1], np.int32)
    dead = np.asarray([False, False, True])
    cache = _paged_cache(rng, quant, [0, 10, 5])
    rows = _page_table(rng, [2, 4, 0])
    rows[2] = rows[1]                                # a dead lane aliases a live row
    k_hat = rng.standard_normal((B, S, KV, DH)).astype(np.float32)
    v_hat = rng.standard_normal((B, S, KV, DH)).astype(np.float32)
    k_act = np.asarray([6, 8, 8], np.int32)
    want = jpc.paged_insert_prefill_chunk(
        _j(cache), jsw, jcfg, jnp.asarray(k_hat), jnp.asarray(v_hat),
        jnp.asarray(start), jnp.asarray(tlen), jnp.asarray(rows),
        k_act=jnp.asarray(k_act), dead=jnp.asarray(dead))
    t = to_torch(cache, device="cpu")
    pc.paged_insert_prefill_chunk_(
        t, tsw, torch.as_tensor(k_hat), torch.as_tensor(v_hat),
        torch.as_tensor(start), torch.as_tensor(tlen), torch.as_tensor(rows),
        k_act=torch.as_tensor(k_act), dead=torch.as_tensor(dead))
    _assert_tree_equal(want, t)


@pytest.mark.parametrize("true_len", [None, 11])
@pytest.mark.parametrize("quant", [None, "fp8"])
def test_insert_prefill_then_paged_scatter_bit_equal(quant, true_len):
    """A bucketed batch=1 prefill (``true_len``) with a per-lane retention
    cap, then its admission into the paged state."""
    rng = np.random.default_rng(2)
    jcfg, tcfg = _cfgs()
    jsw, tsw = _swans(quant)
    S = 16
    k_hat = rng.standard_normal((1, S, KV, DH)).astype(np.float32)
    v_hat = rng.standard_normal((1, S, KV, DH)).astype(np.float32)
    k_act = np.asarray([5], np.int32)
    one_j = jhc.swan_cache_insert_prefill(
        jhc.init_swan_cache(jcfg, jsw, 1, S), jsw, jcfg, jnp.asarray(k_hat),
        jnp.asarray(v_hat), k_act=jnp.asarray(k_act), true_len=true_len)
    one_t = hc.swan_cache_insert_prefill_(
        hc.init_swan_cache(tcfg, tsw, 1, S, "cpu"), tsw,
        torch.as_tensor(k_hat), torch.as_tensor(v_hat),
        k_act=torch.as_tensor(k_act), true_len=true_len)
    _assert_tree_equal(one_j, one_t)

    # stack an [L=1] axis and scatter into a paged state at slot 1
    lead = lambda tree: {k: lead(v) if isinstance(v, dict) else v[None]  # noqa: E731
                         for k, v in tree.items()}
    state = {"pool": {s: {n: x[None] for n, x in
                          _random_side(rng, (NP, KV, PS), None).items()}
                      for s in "kv"}, **lead(_ring(rng, B, [3, 0, 7]))}
    if quant == "fp8":
        for side in state["pool"].values():
            side["vals"] = side["vals"].astype(jnp.float8_e4m3fn)
    phys = np.asarray([5, 9, 0, 0], np.int32)        # 2 mapped pages, 2 trash
    want = jpc.paged_insert_prefill(_j(state), lead(one_j), 1,
                                    jnp.asarray(phys), PS)
    got = pc.paged_insert_prefill_(to_torch(state, "cpu"),
                                   lead(one_t), 1, torch.as_tensor(phys), PS)
    _assert_tree_equal(want, got)


def test_paged_logical_view_equal():
    rng = np.random.default_rng(3)
    cache = _paged_cache(rng, "int8", [5, 9, 30])
    tab = _page_table(rng, [2, 3, 7])[:, :4]          # a table prefix
    want = jswa.paged_logical_view(_j(cache), jnp.asarray(tab))
    got = swa.paged_logical_view(to_torch(cache, "cpu"), torch.as_tensor(tab))
    _assert_tree_equal(want, got)


@pytest.mark.parametrize("buffer", [BUF, 0])
def test_chunk_evict_winnow_and_write_sparse_rows_bit_equal(buffer):
    rng = np.random.default_rng(4)
    jsw, tsw = (JSwan(k_max=K, buffer=buffer), SwanConfig(k_max=K,
                                                          buffer=buffer))
    S = 8
    # lanes: fresh prompt, resumed past the ring, resumed near the slab end,
    # and a dead lane parked at slot = n (3 slots)
    start = np.asarray([0, 9, 26, 0], np.int32)
    tlen = np.asarray([5, 8, 8, 1], np.int32)
    lane = np.asarray([0, 2, 1, 3], np.int32)
    ring = _ring(rng, 4, [0, 9, 26, 3])
    k_hat = rng.standard_normal((4, S, KV, DH)).astype(np.float32)
    v_hat = rng.standard_normal((4, S, KV, DH)).astype(np.float32)
    k_act = np.asarray([8, 4, 6, 8], np.int32)
    j_out = jhc.chunk_evict_winnow(_j(ring), jsw, jnp.asarray(k_hat),
                                   jnp.asarray(v_hat), jnp.asarray(start),
                                   jnp.asarray(tlen), k_act=jnp.asarray(k_act))
    t_out = hc.chunk_evict_winnow(to_torch(ring, "cpu"), tsw,
                                  torch.as_tensor(k_hat),
                                  torch.as_tensor(v_hat),
                                  torch.as_tensor(start),
                                  torch.as_tensor(tlen),
                                  k_act=torch.as_tensor(k_act))
    np.testing.assert_array_equal(np.asarray(j_out[0]), t_out[0].numpy())
    for j, t in zip(j_out[1:], t_out[1:]):        # packed k, v and the rings
        _assert_tree_equal(j, t)
    # commit the packed keys to a 3-slot slab: the dead lane and the rows
    # past SMAX are dropped
    side = _random_side(rng, (3, KV, SMAX), None)
    want = jhc.write_sparse_rows(_j(side), j_out[1], jnp.asarray(lane),
                                 j_out[0])
    got = hc.write_sparse_rows_(to_torch(side, "cpu"), t_out[1], lane,
                                t_out[0])
    _assert_tree_equal(want, got)
