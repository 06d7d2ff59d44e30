"""Port parity for the paged decode read (kernel B2) and the chunk-prefill
stats reads (kernels B3, B4): the wrappers' plain twins against the Pallas
kernels in interpret mode and against the reference's pure paths, on the
same numpy inputs — a page pool with shuffled, non-contiguous pages, a
trash page 0 full of garbage behind every unmapped tail, and per-lane
``sp_len`` of 0, mid-page and full.

Tolerances: the twins follow the Pallas kernels' numerics (f32 q,
dequantised values and sums), so they agree with them at 5e-5 for every
value type.  The reference's pure chunk path (``_sparse_stats_bulk``)
rounds q to the cache dtype before the dot; where that dtype is bf16 (bf16
and fp8 values) the twin differs from it by up to 5e-2 — the cost of
following the kernel."""
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import SwanConfig as JSwan  # noqa: E402
from repro.core.swan_attention import _sparse_stats_bulk as j_bulk  # noqa: E402
from repro.core.swan_attention import \
    swan_decode_attention_paged as j_attention_paged  # noqa: E402
from repro.kernels.flash_prefill.swan_chunk import (  # noqa: E402
    swan_chunk_stats_paged_pallas, swan_chunk_stats_pallas)
from repro.kernels.swan_decode.swan_decode import \
    swan_decode_paged_pallas  # noqa: E402
from repro_torch.configs import SwanConfig  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core.swan_attention import (  # noqa: E402
    gather_pages, paged_logical_view, swan_decode_attention_paged,
    swan_decode_attention_reference)
from repro_torch.kernels.swan_chunk import swan_chunk as sck  # noqa: E402
from repro_torch.kernels.swan_decode import swan_decode as sdk  # noqa: E402

P, KV, G, DH, K, PS, PG, NPAGES, BUF, C = 2, 2, 2, 16, 8, 8, 4, 12, 8, 4
Q, S = C * G, PS * PG

KINDS = {"f32": np.float32, "bf16": ml_dtypes.bfloat16, "int8": np.float32,
         "fp8": np.float32}
# per-lane valid sparse prefix: empty + mid-page, full + one row
CASES = {"empty_and_mid": [0, 20], "full_and_one": [S, 1]}
PURE_TOL = {"f32": 5e-5, "int8": 5e-5, "bf16": 5e-2, "fp8": 5e-2}


def _inputs(kind: str, case: str, seed: int = 0):
    """A page pool, page-table rows mapping ceil(sp_len / PS) shuffled
    pages per lane (the rest trash), decode ring operands, and chunk q."""
    rng = np.random.default_rng(seed)
    qdt = KINDS[kind]
    sp_len = np.asarray(CASES[case], np.int32)
    pages = rng.permutation(np.arange(1, NPAGES))
    tab = np.zeros((P, PG), np.int32)                 # 0 = trash page
    used = 0
    for p, n in enumerate(sp_len):
        m = -(-int(n) // PS)
        tab[p, :m] = pages[used:used + m]
        used += m
    idx = lambda: np.stack([rng.permutation(DH)[:K]  # noqa: E731
                            for _ in range(NPAGES * KV * PS)]
                           ).reshape(NPAGES, KV, PS, K).astype(np.int8)
    a = {"k_idx": idx(), "v_idx": idx(), "sp_len": sp_len, "page_tab": tab,
         "q_chunk": rng.standard_normal((P, KV, Q, DH)).astype(np.float32),
         "q": rng.standard_normal((P, KV, G, DH)).astype(qdt),
         "buf_k": rng.standard_normal((P, KV, BUF, DH)).astype(qdt),
         "buf_v": rng.standard_normal((P, KV, BUF, DH)).astype(qdt)}
    pos = np.where(sp_len > 0, sp_len + BUF - 1, 5).astype(np.int32)
    buf_pos = np.full((P, BUF), -1, np.int32)
    for b, p_ in enumerate(pos):
        for t in range(max(p_ - BUF + 1, 0), p_ + 1):
            buf_pos[b, t % BUF] = t
    a.update(pos=pos, buf_pos=buf_pos)
    for s in "kv":
        if kind == "int8":
            a[f"{s}_vals"] = rng.integers(-127, 128, (NPAGES, KV, PS, K)
                                          ).astype(np.int8)
            a[f"{s}_scale"] = (rng.random((NPAGES, KV, PS)) * 0.1
                               + 0.01).astype(np.float32)
        else:
            vdt = ml_dtypes.float8_e4m3fn if kind == "fp8" else qdt
            a[f"{s}_vals"] = rng.standard_normal((NPAGES, KV, PS, K)
                                                 ).astype(vdt)
    return a


def _logical(x, tab):
    """numpy page gather: [n_pages, Kv, ps, ...] -> [P, Kv, Pg*ps, ...]."""
    v = np.moveaxis(x[tab], 2, 1)
    return v.reshape(v.shape[0], v.shape[1], -1, *v.shape[4:])


def _leaves(a, names=("vals", "idx", "scale")):
    return {f"{s}_{n}": a[f"{s}_{n}"] for s in "kv" for n in names
            if f"{s}_{n}" in a}


def _sides(leaves):
    return {s: {n: leaves[f"{s}_{n}"] for n in ("vals", "idx", "scale")
                if f"{s}_{n}" in leaves} for s in "kv"}


def _swan(kind, cls):
    return cls(k_max=K, buffer=BUF, quantize=kind in ("int8", "fp8"),
               quant_dtype="fp8" if kind == "fp8" else "int8")


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", list(KINDS))
def test_chunk_stats_twins_match_pallas_and_pure_path(kind, case):
    a = _inputs(kind, case)
    pool = _leaves(a)
    view = {n: _logical(x, a["page_tab"]) for n, x in pool.items()}
    j = lambda d: {n: jnp.asarray(x) for n, x in d.items()}  # noqa: E731
    jv, jp = j(view), j(pool)
    jq, jsp = jnp.asarray(a["q_chunk"]), jnp.asarray(a["sp_len"])
    pal = swan_chunk_stats_pallas(
        jq, jv["k_vals"], jv["k_idx"], jv["v_vals"], jv["v_idx"], jsp,
        k_scale=jv.get("k_scale"), v_scale=jv.get("v_scale"), interpret=True)
    pal_paged = swan_chunk_stats_paged_pallas(
        jq, jp["k_vals"], jp["k_idx"], jp["v_vals"], jp["v_idx"], jsp,
        jnp.asarray(a["page_tab"]), pool_k_scale=jp.get("k_scale"),
        pool_v_scale=jp.get("v_scale"), interpret=True)
    pure = j_bulk(jq, *_sides(jv).values(), _swan(kind, JSwan), jsp, DH)

    t = to_torch(a, device="cpu")
    tv, tp = to_torch(view, device="cpu"), to_torch(pool, device="cpu")
    launches = (sck.KERNEL.launches, sck.KERNEL_PAGED.launches)
    slab = sck.swan_chunk_stats(
        t["q_chunk"], tv["k_vals"], tv["k_idx"], tv["v_vals"], tv["v_idx"],
        t["sp_len"], k_scale=tv.get("k_scale"), v_scale=tv.get("v_scale"))
    paged = sck.swan_chunk_stats_paged(
        t["q_chunk"], tp["k_vals"], tp["k_idx"], tp["v_vals"], tp["v_idx"],
        t["sp_len"], t["page_tab"], pool_k_scale=tp.get("k_scale"),
        pool_v_scale=tp.get("v_scale"))
    assert (sck.KERNEL.launches, sck.KERNEL_PAGED.launches) == launches
    for got in (slab, paged):
        assert [x.dtype for x in got] == [torch.float32] * 3
        _close(got, pal, 5e-5)
        _close(got, pal_paged, 5e-5)
        _close(got, pure, PURE_TOL[kind])
    for x, y in zip(slab, paged):                   # paged == slab, bit for bit
        assert torch.equal(x, y)
    empty = torch.as_tensor(a["sp_len"]) == 0       # m_safe = l = o = 0
    for x in slab:
        assert not x[empty].any()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", list(KINDS))
def test_paged_decode_twin_matches_pallas_and_pure_path(kind, case):
    a = _inputs(kind, case)
    pool = _leaves(a)
    sp_len = np.maximum(a["pos"] + 1 - BUF, 0).astype(np.int32)
    assert (sp_len == a["sp_len"]).all()
    j = {n: jnp.asarray(x) for n, x in a.items()}
    jp = {n: jnp.asarray(x) for n, x in pool.items()}
    pal = swan_decode_paged_pallas(
        j["q"], jp["k_vals"], jp["k_idx"], jp["v_vals"], jp["v_idx"],
        j["buf_k"], j["buf_v"], j["buf_pos"], j["pos"], j["sp_len"],
        j["page_tab"], pool_k_scale=jp.get("k_scale"),
        pool_v_scale=jp.get("v_scale"), interpret=True)
    jcache = {"pool": _sides(jp), "buf_k": j["buf_k"], "buf_v": j["buf_v"],
              "buf_pos": j["buf_pos"]}
    j_pure = j_attention_paged(j["q"], jcache, _swan(kind, JSwan), None,
                               j["pos"], j["page_tab"])

    t = to_torch(a, device="cpu")
    tp = to_torch(pool, device="cpu")
    args = (t["buf_k"], t["buf_v"], t["buf_pos"], t["pos"], t["sp_len"])
    launches = sdk.KERNEL_PAGED.launches
    twin = sdk.swan_decode_paged(
        t["q"], tp["k_vals"], tp["k_idx"], tp["v_vals"], tp["v_idx"], *args,
        t["page_tab"], pool_k_scale=tp.get("k_scale"),
        pool_v_scale=tp.get("v_scale"))
    assert sdk.KERNEL_PAGED.launches == launches
    cache = {"pool": _sides(tp), "buf_k": t["buf_k"], "buf_v": t["buf_v"],
             "buf_pos": t["buf_pos"]}
    view = paged_logical_view(cache, t["page_tab"])
    slab_twin = sdk.swan_decode(
        t["q"], view["k"]["vals"], view["k"]["idx"], view["v"]["vals"],
        view["v"]["idx"], *args, k_scale=view["k"].get("scale"),
        v_scale=view["v"].get("scale"))
    assert torch.equal(twin, slab_twin)              # B2 twin == B1 twin
    swan = _swan(kind, SwanConfig)
    pure = swan_decode_attention_paged(t["q"], cache, swan, t["pos"],
                                       t["page_tab"])
    oracle = swan_decode_attention_reference(t["q"], view, swan, t["pos"])
    tol = 5e-2 if kind == "bf16" else 5e-5
    for got, atol in ((twin, tol), (oracle, tol), (pure, PURE_TOL[kind])):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(pal, np.float32), atol=atol)
    np.testing.assert_allclose(pure.float().numpy(),
                               np.asarray(j_pure, np.float32), atol=tol)


def _good_chunk():
    a = to_torch(_inputs("bf16", "empty_and_mid"), device="cpu")
    return {"q": a["q_chunk"], "k_vals": a["k_vals"], "k_idx": a["k_idx"],
            "v_vals": a["v_vals"], "v_idx": a["v_idx"], "sp_len": a["sp_len"],
            "page_rows": a["page_tab"]}


def _call_chunk(t, paged):
    args = [t[n] for n in ("q", "k_vals", "k_idx", "v_vals", "v_idx",
                           "sp_len")]
    if paged:
        return sck.swan_chunk_stats_paged(*args, t["page_rows"])
    view = {n: gather_pages(t[n], t["page_rows"])
            for n in ("k_vals", "k_idx", "v_vals", "v_idx")}
    return sck.swan_chunk_stats(t["q"], view["k_vals"], view["k_idx"],
                                view["v_vals"], view["v_idx"], t["sp_len"])


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("mutate, err", [
    (lambda t: t.update(q=t["q"].bfloat16()), TypeError),
    (lambda t: t.update(k_idx=t["k_idx"].long()), TypeError),
    (lambda t: t.update(k_vals=t["k_vals"].to(torch.int8),
                        v_vals=t["v_vals"].to(torch.int8)), TypeError),
    (lambda t: t.update(sp_len=t["sp_len"].long()), TypeError),
    (lambda t: t.update(q=t["q"][:, :1].contiguous()), ValueError),
    (lambda t: t.update(k_vals=t["k_vals"][..., :-1].contiguous()),
     ValueError),
])
def test_chunk_wrappers_reject_bad_operands(mutate, err, paged):
    t = _good_chunk()
    _call_chunk(t, paged)                            # the good operands pass
    mutate(t)
    with pytest.raises(err):
        _call_chunk(t, paged)


@pytest.mark.parametrize("rows, err", [
    (lambda r: r[:, :0], ValueError),                # empty table prefix
    (lambda r: r[:1], ValueError),                   # not one row per lane
    (lambda r: r.long(), TypeError),
])
def test_paged_wrappers_reject_bad_page_table(rows, err):
    t = _good_chunk()
    bad = rows(t["page_rows"])
    with pytest.raises(err):
        sck.swan_chunk_stats_paged(t["q"], t["k_vals"], t["k_idx"],
                                   t["v_vals"], t["v_idx"], t["sp_len"], bad)
    a = to_torch(_inputs("f32", "empty_and_mid"), device="cpu")
    with pytest.raises(err):
        sdk.swan_decode_paged(a["q"], a["k_vals"], a["k_idx"], a["v_vals"],
                              a["v_idx"], a["buf_k"], a["buf_v"],
                              a["buf_pos"], a["pos"], a["sp_len"], bad)


def _tc_smem(dh, k, vb, q_parts=2):
    """The tensor-core body's shared memory: expanded bf16 k and v tiles of
    64 rows ([64, dh16 + 8]), the q tile as q_parts bf16 parts ([128, dh16
    + 8] each; three for int8), two staging buffers of 64 packed rows
    (vals, idx and scales of both sides, regions rounded up to 16 bytes)."""
    a16 = lambda n: -(-n // 16) * 16  # noqa: E731
    row = (a16(dh) + 8) * 2
    stage = 2 * (a16(64 * k * vb) + a16(64 * k) + 64 * 4)
    return (2 * 64 + q_parts * 128) * row + 2 * stage


def test_chunk_precheck_budget():
    ok = sck.precheck(dh=128, k_max=64, S=4096)
    # the engine chunk's bf16 body: 34,816 B of expanded tiles, 69,632 B of
    # q parts and two 25,088 B staging buffers
    assert not ok["errors"]
    assert ok["smem_bytes"] == _tc_smem(128, 64, 2) == 154_624
    assert sck.precheck(dh=128, k_max=129, S=4096)["errors"]
    assert sck.precheck(dh=256, k_max=64, S=4096)["errors"]
    assert sck.precheck(dh=128, k_max=64, S=0)["errors"]


@pytest.mark.parametrize("dh", [16, 20, 40, 64, 100, 128])
def test_chunk_precheck_budget_of_each_body(dh):
    """Every dh up to 128 fits each body; a dh that is not a multiple of 16
    is accepted (the tiles pad it with zero columns, which is exact)."""
    k = min(64, dh)
    for dtype, vb in ((torch.bfloat16, 2), (torch.float8_e4m3fn, 1)):
        got = sck.precheck(dh=dh, k_max=k, S=64, v_dtype=dtype)
        assert got["errors"] == [] and got["smem_bytes"] == _tc_smem(dh, k, vb)
    got = sck.precheck(dh=dh, k_max=k, S=64, v_dtype=torch.int8)
    assert got["errors"] == []
    assert got["smem_bytes"] == _tc_smem(dh, k, 1, q_parts=3)
    f32 = sck.precheck(dh=dh, k_max=k, S=64, v_dtype=torch.float32)
    assert f32["errors"] == []
    assert f32["smem_bytes"] == 4 * (64 * (dh + 4) + 2 * 32 * (dh + 1) + 64 * 33)
    worst = sck.precheck(dh=dh, k_max=dh, S=64, v_dtype=torch.int8)
    assert worst["smem_bytes"] <= sck.SMEM_PER_BLOCK


# ---------------------------------------------------------------------------
# The tensor-core kernel's numerics, emulated in plain torch.  For bf16, int8
# and fp8 values the CUDA kernel expands each tile of 64 packed rows into bf16
# (exact for those types), splits the f32 q into q_hi + q_lo bf16 halves (two
# products for S; int8 adds a third part q_lo2), multiplies S by the int8 key
# scale after the product, runs the online softmax in f32 in natural units
# (exp2 of (s - m)·log2 e), folds the int8 value scale into p and splits p
# into p_hi + p_lo (two products for O), and sums l over the f32 p, every
# product accumulated in f32.  f32 values keep a CUDA-core f32 body, emulated
# with f32 operands.  The emulation must agree with the plain twin within
# chip_smoke.py's tolerances (1e-5 for f32 values, 1e-4 for the others);
# without the lo halves it must miss 1e-5.
# ---------------------------------------------------------------------------

EMU = dict(P=2, Kv=2, Q=40, S=160, dh=128)          # three row tiles: 64, 64, 32
EMU_TOL = {"f32": 1e-5, "bf16": 1e-4, "int8": 1e-4, "fp8": 1e-4}
ROW_TILE = sck.TILES["tensor_core"][1]


def _emu_inputs(kind, k, seed=11):
    """Seeded operands of one chunk read at EMU shapes, sp_len (150, 0)."""
    rng = np.random.default_rng(seed)
    P, Kv, Q, S, dh = (EMU[n] for n in ("P", "Kv", "Q", "S", "dh"))
    a = {"q": rng.standard_normal((P, Kv, Q, dh)).astype(np.float32),
         "sp_len": np.asarray([150, 0], np.int32)}
    for s in "kv":
        a[f"{s}_idx"] = np.stack([rng.permutation(dh)[:k] for _ in
                                  range(P * Kv * S)]).reshape(P, Kv, S, k
                                                              ).astype(np.int8)
        if kind == "int8":
            a[f"{s}_vals"] = rng.integers(-128, 128, (P, Kv, S, k)
                                          ).astype(np.int8)
            a[f"{s}_scale"] = (np.abs(rng.standard_normal((P, Kv, S))) * 0.05
                               + 0.01).astype(np.float32)
        else:
            vdt = {"f32": np.float32, "bf16": ml_dtypes.bfloat16,
                   "fp8": ml_dtypes.float8_e4m3fn}[kind]
            a[f"{s}_vals"] = rng.standard_normal((P, Kv, S, k)).astype(vdt)
    return to_torch(a, device="cpu")


def _emulate_chunk_kernel(t, split=True):
    """The CUDA kernel's operand scheme on CPU: (m_safe, l, o_unnorm)."""
    q = t["q"]
    P, Kv, Q, dh = q.shape
    S = t["k_vals"].shape[2]
    tensor_core = t["k_vals"].dtype != torch.float32
    bf = lambda x: x.bfloat16().float()  # noqa: E731

    def parts(x, n):
        """x as n bf16 parts (hi, lo, lo2), f32 itself on the f32 body."""
        if not tensor_core:
            return [x]
        out = []
        for _ in range(n if split else 1):
            out.append(bf(x - sum(out)))
        return out

    def dense(s):
        d = torch.zeros(P, Kv, S, dh)
        return d.scatter_(-1, t[f"{s}_idx"].long(), t[f"{s}_vals"].float())

    kd, vd = dense("k"), dense("v")
    assert not tensor_core or torch.equal(bf(kd), kd)   # exact in bf16
    ksc, vsc = t.get("k_scale"), t.get("v_scale")
    q_parts = 3 if ksc is not None else 2
    log2e = math.log2(math.e)
    m = torch.full((P, Kv, Q), -1e30)
    l, o = torch.zeros(P, Kv, Q), torch.zeros(P, Kv, Q, dh)
    for t0 in range(0, S, ROW_TILE):
        rows = slice(t0, t0 + ROW_TILE)
        s = sum(h @ kd[:, :, rows].transpose(-1, -2) for h in parts(q, q_parts))
        if ksc is not None:
            s = s * ksc[:, :, None, rows]
        s = s / math.sqrt(dh)
        valid = (torch.arange(t0, min(t0 + ROW_TILE, S))[None, None, None]
                 < t["sp_len"][:, None, None, None])
        s = torch.where(valid, s, torch.tensor(-1e30))
        mx = torch.maximum(m, s.amax(-1))
        corr = torch.exp2((m - mx) * log2e)
        p = torch.where(valid, torch.exp2((s - mx[..., None]) * log2e),
                        torch.tensor(0.))
        l = l * corr + p.sum(-1)
        pv = p if vsc is None else p * vsc[:, :, None, rows]
        o = o * corr[..., None] + sum(h @ vd[:, :, rows] for h in parts(pv, 2))
        m = mx
    m_safe = torch.where(m > -5e29, m, torch.tensor(0.))
    return m_safe, l, o


def _stats_err(got, want):
    """chip_smoke.py's error of chunk stats: m_safe abs, l and o/l relative
    (abs / (1 + |want|)), o/l over the queries with a live prefix."""
    (m, l, o), (wm, wl, wo) = got, want
    live = wl > 0
    on = lambda x, y: x / y.clamp(min=1e-30)[..., None]  # noqa: E731
    ol = ((on(o, l) - on(wo, wl))[live].abs()
          / (1 + on(wo, wl)[live].abs()))
    return max((m - wm).abs().max().item(),
               ((l - wl).abs() / (1 + wl.abs())).max().item(),
               ol.max().item() if ol.numel() else 0.0)


def _twin(t):
    return sck.swan_chunk_stats_plain(
        t["q"], t["k_vals"], t["k_idx"], t["v_vals"], t["v_idx"],
        t["sp_len"], t.get("k_scale"), t.get("v_scale"))


@pytest.mark.parametrize("k", [1, 32, 64])
@pytest.mark.parametrize("kind", list(KINDS))
def test_kernel_numerics_scheme_meets_chip_tolerance(kind, k):
    t = _emu_inputs(kind, k)
    got, want = _emulate_chunk_kernel(t), _twin(t)
    assert _stats_err(got, want) <= EMU_TOL[kind]
    for x in got:                                   # the dead lane: (0, 0, 0)
        assert not x[1].any()


@pytest.mark.parametrize("k", [32, 64])
@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
def test_kernel_numerics_need_the_lo_halves(kind, k):
    """One bf16 rounding of q and of p misses the f32 tolerance (1e-5) by
    far: the split is what holds the tensor-core body to the contract."""
    t = _emu_inputs(kind, k)
    assert _stats_err(_emulate_chunk_kernel(t, split=False), _twin(t)) > 1e-5
