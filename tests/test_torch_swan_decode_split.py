"""The split plan of the Hopper decode kernels (B1 slab, B2 paged), emulated
in plain torch on the CPU: the prefix cut into ``SPLIT_ROWS``-row splits,
each split staged in ``TILE_ROWS``-row tiles whose rows go ``TILE_ROWS //
N_WARPS`` to a warp, a per-warp online softmax rescaled once per tile, the
warps merged in warp order into the split's (m, l, acc), the ring as the
last split, and the splits merged in split order (only those below
sp_len) — the arithmetic of ``csrc/swan_decode.cu`` in f32, with its
finite -1e30 for minus infinity and its 1e-30 floor on the denominator.

Held against the port's plain twin and the JAX oracle and Pallas kernel
(interpret mode), at f32 within 5e-5 (tests/test_kernels.py's f32
tolerance), for prefixes that end on and around the split and tile
edges; and, bit for bit, against itself planned over the slab extent S and
over a smaller paged extent Pg·ps holding the same logical rows."""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.swan_decode.ref import swan_decode_reference as j_reference  # noqa: E402
from repro.kernels.swan_decode.swan_decode import swan_decode_pallas  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core.swan_attention import gather_pages  # noqa: E402
from repro_torch.kernels.swan_decode.ref import swan_decode_reference  # noqa: E402
from repro_torch.kernels.swan_decode.swan_decode import (  # noqa: E402
    N_WARPS, SPLIT_ROWS, TILE_ROWS, n_splits)

R = SPLIT_ROWS
B, KV, G, DH, K, BUF, PS = 3, 2, 2, 16, 8, 8, 16
S = 3 * R                                  # three prefix splits in the slab
NEG = -1e30                                # the kernel's minus infinity
TOL = 5e-5

# sp_len per sequence
CASES = {
    "sp_len=0": [0, 0, 0],
    "below one tile": [1, 5, TILE_ROWS - 1],
    "R-1, R, R+1": [R - 1, R, R + 1],
    "not a multiple of R": [R + 17, 2 * R - 3, TILE_ROWS + 1],
    "full prefix": [S, S, S],
    "most splits empty": [1, S, 7],
}
ARGS = ("q", "k_vals", "k_idx", "v_vals", "v_idx", "buf_k", "buf_v",
        "buf_pos", "pos", "sp_len")


def _inputs(vals_kind, sp_len, seed=0):
    rng = np.random.default_rng(seed)
    sp = np.asarray(sp_len, np.int32)
    # a full ring behind each prefix; with no prefix, a partly filled one
    pos = np.where(sp > 0, sp + BUF - 1, np.arange(B) + 2).astype(np.int32)
    buf_pos = np.full((B, BUF), -1, np.int32)
    for bi, p in enumerate(pos):
        for t in range(max(p - BUF + 1, 0), p + 1):
            buf_pos[bi, t % BUF] = t
    idx = lambda: np.stack([rng.permutation(DH)[:K] for _ in range(B * KV * S)]
                           ).reshape(B, KV, S, K).astype(np.int8)
    a = {"q": rng.standard_normal((B, KV, G, DH)).astype(np.float32),
         "k_idx": idx(), "v_idx": idx(),
         "buf_k": rng.standard_normal((B, KV, BUF, DH)).astype(np.float32),
         "buf_v": rng.standard_normal((B, KV, BUF, DH)).astype(np.float32),
         "buf_pos": buf_pos, "pos": pos, "sp_len": sp}
    for s in "kv":
        if vals_kind == "int8":
            a[f"{s}_vals"] = rng.integers(-127, 128, (B, KV, S, K)).astype(np.int8)
            a[f"{s}_scale"] = (rng.random((B, KV, S)) * 0.1 + 0.01).astype(np.float32)
        else:
            a[f"{s}_vals"] = rng.standard_normal((B, KV, S, K)).astype(np.float32)
    return a


def _dense(vals, idx, scale):
    v = vals.float() if scale is None else vals.float() * scale[..., None]
    out = torch.zeros((*v.shape[:-1], DH))
    return out.scatter_(-1, idx.long(), v)


def _online(m, l, acc, s, v):
    """One rescale of a warp's (m, l, acc) [Kv,G], [Kv,G], [Kv,G,dh] by its
    rows' scores s [Kv,G,r] and values v [Kv,r,dh]."""
    mt = s.amax(-1) if s.shape[-1] else torch.full_like(m, NEG)
    m_new = torch.maximum(m, mt)
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    return (m_new, l * corr + p.sum(-1),
            acc * corr[..., None] + torch.einsum("jgr,jrd->jgd", p, v))


def _merge(parts):
    """(m, l, acc) partials merged in list order (the kernel's fixed order)."""
    mx = parts[0][0]
    for m, _, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    l_sum, acc = torch.zeros_like(mx), torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        c = torch.exp(m - mx)
        l_sum = l_sum + l * c
        acc = acc + a * c[..., None]
    return mx, l_sum, acc


def split_plan_decode(t, extent):
    """o [B,Kv,G,dh] f32 by the kernels' plan over ``extent`` logical rows
    (the slab's S, or Pg·ps) of the dense-expanded rows in ``t``."""
    q = t["q"].float()
    kd = _dense(t["k_vals"], t["k_idx"], t.get("k_scale"))
    vd = _dense(t["v_vals"], t["v_idx"], t.get("v_scale"))
    scale = 1.0 / math.sqrt(DH)
    rpw = TILE_ROWS // N_WARPS
    out = torch.empty(B, KV, G, DH)
    for bi in range(B):
        n_sp = min(max(int(t["sp_len"][bi]), 0), extent)
        n_act = -(-n_sp // R)
        assert n_act <= n_splits(extent)
        parts = []
        for j in range(n_act):                     # the active prefix splits
            row0, n_end = j * R, min(n_sp, (j + 1) * R)
            warps = [(torch.full((KV, G), NEG), torch.zeros(KV, G),
                      torch.zeros(KV, G, DH)) for _ in range(N_WARPS)]
            for t0 in range(row0, n_end, TILE_ROWS):
                n = min(TILE_ROWS, n_end - t0)
                for w in range(N_WARPS):
                    rows = [t0 + w * rpw + r for r in range(rpw)
                            if w * rpw + r < n]
                    s = torch.einsum("jgd,jrd->jgr", q[bi], kd[bi][:, rows]) * scale
                    warps[w] = _online(*warps[w], s, vd[bi][:, rows])
            parts.append(_merge(warps))            # warps in warp order
        # the ring split (its l on warp 0; all warps share its max)
        ok = (t["buf_pos"][bi] >= 0) & (t["buf_pos"][bi] <= t["pos"][bi])
        s = torch.einsum("jgd,jrd->jgr", q[bi], t["buf_k"][bi].float()) * scale
        s = torch.where(ok, s, torch.tensor(NEG))
        mx = s.amax(-1)
        p = torch.where(ok, torch.exp(s - mx[..., None]), torch.tensor(0.0))
        parts.append((mx, p.sum(-1),
                      torch.einsum("jgr,jrd->jgd", p, t["buf_v"][bi].float())))
        _, l_sum, acc = _merge(parts)              # splits in order, ring last
        out[bi] = acc / torch.clamp(l_sum, min=1e-30)[..., None]
    return out


def _paged(t, seed=1):
    """The same logical rows through a shuffled page pool full of garbage,
    with a table of Pg = ceil(max sp_len / ps) pages (at least one)."""
    gen = torch.Generator().manual_seed(seed)
    pg = max(-(-int(t["sp_len"].max()) // PS), 1)
    n_pages = B * pg + 1
    perm = torch.randperm(n_pages - 1, generator=gen) + 1
    tab = torch.zeros((B, pg), dtype=torch.int32)
    for bi in range(B):
        m = -(-int(t["sp_len"][bi]) // PS)
        tab[bi, :m] = perm[bi * pg: bi * pg + m]
    p = dict(t)
    for n in ("k_vals", "k_idx", "v_vals", "v_idx", "k_scale", "v_scale"):
        if n not in t:
            continue
        x = t[n]
        shape = (n_pages, KV, PS) + tuple(x.shape[3:])
        if n.endswith("idx"):
            pool = torch.randint(0, DH, shape, generator=gen).to(x.dtype)
        elif x.dtype == torch.int8:
            pool = torch.randint(-128, 128, shape, generator=gen).to(x.dtype)
        else:
            pool = torch.randn(shape, generator=gen) * 1e3
        for bi in range(B):
            m = -(-int(t["sp_len"][bi]) // PS)
            rows = x[bi, :, :m * PS].reshape(KV, m, PS, *x.shape[3:])
            pool[tab[bi, :m].long()] = rows.transpose(0, 1)
        p[n] = gather_pages(pool, tab)             # [B, Kv, Pg·ps, ...]
    return p, pg * PS


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("vals_kind", ["f32", "int8"])
def test_split_plan_matches_reference_and_pallas(vals_kind, case):
    a = _inputs(vals_kind, CASES[case])
    t = to_torch(a, device="cpu")
    got = split_plan_decode(t, S)
    assert torch.isfinite(got).all()

    twin = swan_decode_reference(*[t[n] for n in ARGS], t.get("k_scale"),
                                 t.get("v_scale")).float()
    j = {n: jnp.asarray(v) for n, v in a.items()}
    kw = {"k_scale": j.get("k_scale"), "v_scale": j.get("v_scale")}
    ref = np.asarray(j_reference(*[j[n] for n in ARGS], **kw), np.float32)
    pal = np.asarray(swan_decode_pallas(*[j[n] for n in ARGS], **kw,
                                        block_s=128, interpret=True), np.float32)
    for want in (twin.numpy(), ref, pal):
        np.testing.assert_allclose(got.numpy(), want, atol=TOL)

    # the same logical rows planned over a paged extent Pg·ps (< S unless
    # the prefix is full): only the splits below sp_len are read, so the bits
    # agree whatever the extent
    paged, extent = _paged(t)
    assert extent <= S and n_splits(extent) <= n_splits(S)
    assert torch.equal(split_plan_decode(paged, extent), got)
