"""CPU emulation of what the CUDA kernel of fused winnowing (B6,
``kernels/swan_prune/csrc/swan_prune.cu``) computes, held against its plain
twin ``swan_prune_plain``:

* the sort: one 64-bit key per element, ``|x̂| bits << 8 | (127 - col) << 1
  | sign``, through the kernel's exact bitonic schedule (8 lanes of 16 keys
  a vector, lane j loading the 16-byte chunks j + 8m, in-lane steps below
  distance 16, lane-exchange steps from 16 up) must give the twin's idx and
  vals bit for bit, ties and ±0.0 included, dh padded to 128;
* the rotation: x . P as the sum of x . P_hi, x . P_mid and x . P_lo, three
  bf16 parts of f32 P, accumulated in f32 k-step by k-step as the kernel's
  mma.sync loop does, stays within 2^-20 · (|x| . |P|) of the twin's f32
  x̂, and selects the twin's idx on every vector clear of near-ties;
* the budget: ``precheck`` reports the shared memory that ``smem_bytes``
  (the CUDA source's layout) gives, within a Hopper block's."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.device import f32_matmul  # noqa: E402
from repro_torch.kernels.swan_prune import swan_prune as spk  # noqa: E402

D, LANES = spk.MAX_DH, 8          # kD, kLanes in the CUDA source
KEYS = D // LANES                 # kKeys


def _x_hat(x, p):
    """The twin's f32 rotation (``kernels/swan_prune/ref.py``)."""
    with f32_matmul():
        return torch.einsum("bjsd,jde->bjse", x.float(), p.float())


def _keys(xh):
    """[N, dh] f32 -> the kernel's keys [N, LANES, KEYS] int64: columns
    padded with zeros to D, key i of lane j from column 4(j + LANES (i //
    4)) + i % 4."""
    N, dh = xh.shape
    h = torch.zeros(N, D)
    h[:, :dh] = xh
    u = h.view(torch.int32).long() & 0xFFFFFFFF
    col = torch.arange(D)
    key = ((u & 0x7FFFFFFF) << 8) | ((D - 1 - col) << 1) | (u >> 31)
    j = torch.arange(LANES)[:, None]
    i = torch.arange(KEYS)[None]
    return key[:, 4 * (j + LANES * (i // 4)) + i % 4]


def _bitonic(key):
    """The CUDA source's ``bitonic_sort<2>``, step by step, on [N, LANES,
    KEYS] keys; returns them in network positions (lane j: KEYS j ..)."""
    key = key.clone()
    j = torch.arange(LANES)[:, None]
    s = 2
    while s <= D:
        d = s // 2
        while d >= 1:
            if d >= KEYS:                    # partner: key i of lane j ^ d/KEYS
                lower = (j & (d // KEYS)) == 0
                asc = ((KEYS * j) & s) != 0
                keep_max = lower != asc
                o = key[:, torch.arange(LANES) ^ (d // KEYS)]
                key = torch.where((key > o) == keep_max, key, o)
            else:                            # partner: key i + d of lane j
                lo = torch.tensor([q for q in range(KEYS) if not q & d])
                asc = ((KEYS * j + lo[None]) & s) != 0
                a, b = key[:, :, lo], key[:, :, lo + d]
                swap = (a < b) != asc
                key[:, :, lo] = torch.where(swap, b, a)
                key[:, :, lo + d] = torch.where(swap, a, b)
            d //= 2
        s *= 2
    return key.reshape(key.shape[0], D)


def _emulate(xh, k, dtype):
    """Top k of [..., dh] x̂ as the kernel packs them: (vals, idx int8)."""
    return _pack(_bitonic(_keys(xh.reshape(-1, xh.shape[-1]))),
                 xh.shape[:-1], k, dtype)


def _pack(key, lead, k, dtype):
    """The first k of the network's sorted keys [N, D] as the kernel packs
    them: (vals [*lead, k] in ``dtype``, idx int8)."""
    key = key[:, :k]
    bits = ((key >> 8) & 0x7FFFFFFF) | ((key & 1) << 31)
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)   # as int32
    vals = bits.to(torch.int32).view(torch.float32)
    idx = D - 1 - ((key >> 1) & (D - 1))
    return (vals.to(dtype).reshape(*lead, k),
            idx.to(torch.int8).reshape(*lead, k))


def _orthogonal(rng, kv, dh):
    q, r = np.linalg.qr(rng.standard_normal((kv, dh, dh)))
    return torch.from_numpy((q * np.sign(np.diagonal(r, axis1=-2, axis2=-1)
                                         )[:, None]).astype(np.float32))


def _signed_permutation(rng, kv, dh):
    p = np.zeros((kv, dh, dh), np.float32)
    for h in range(kv):
        p[h, np.arange(dh), rng.permutation(dh)] = rng.choice([-1.0, 1.0], dh)
    return torch.from_numpy(p)


def _inputs(kind, dh, dtype=torch.bfloat16):
    """(x [2, 2, 24, dh], P [2, dh, dh] f32).  ``normal``: x from a normal,
    P random orthogonal.  ``ties``: x drawn from {±0.0, ±0.5, ±1, ±2}
    (equal magnitudes, of both signs, and signed zeros in every vector), P
    a signed permutation, so x̂ keeps the ties exactly."""
    rng = np.random.default_rng(dh)
    shape = (2, 2, 24, dh)
    if kind == "normal":
        x = rng.standard_normal(shape).astype(np.float32)
        p = _orthogonal(rng, 2, dh)
    else:
        x = rng.choice(np.array([-2.0, -1.0, -0.5, -0.0, 0.0, 0.5, 1.0, 2.0],
                                np.float32), shape)
        p = _signed_permutation(rng, 2, dh)
    return torch.from_numpy(x).to(dtype), p


def _bits(v):
    return v.view(torch.int16 if v.dtype == torch.bfloat16 else torch.int32)


@functools.lru_cache(maxsize=None)
def _network(kind, dh, dtype, rotated=True):
    """The network's sorted keys [N, D] of one input's x̂ (``rotated``) or
    of x itself: every k of that input reads them (the sort does not
    depend on k), so each input goes through the network once per
    module."""
    x, p = _inputs(kind, dh, dtype)
    xh = _x_hat(x, p) if rotated else x.float()
    return _bitonic(_keys(xh.reshape(-1, dh)))


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("dh", [16, 32, 80, 128])
@pytest.mark.parametrize("kq", ["1", "7", "dh/2", "dh"])
def test_sorting_network_equals_the_twin(kind, dh, kq):
    k = {"1": 1, "7": 7, "dh/2": dh // 2, "dh": dh}[kq]
    for dtype in (torch.bfloat16, torch.float32):
        x, p = _inputs(kind, dh, dtype)
        want_v, want_i = spk.swan_prune_plain(x, p, k)
        got_v, got_i = _pack(_network(kind, dh, dtype), x.shape[:-1], k,
                             dtype)
        assert torch.equal(got_i, want_i)
        assert torch.equal(_bits(got_v), _bits(want_v))
        if kind == "ties":
            # a rotation's sums never give -0.0 (+0.0 products join every
            # sum), so signed zeros go to the selection directly: x̂ = x,
            # against the twin's stable descending sort on |x̂|
            xh = x.float()
            assert bool((xh == 0).any() and (torch.signbit(xh) & (xh == 0)).any())
            mag = xh.abs()
            assert (mag[..., :, None] == mag[..., None, :]).sum() > 2 * xh.numel()
            want_i = torch.sort(-mag, dim=-1, stable=True).indices[..., :k]
            got_v, got_i = _pack(_network(kind, dh, dtype, rotated=False),
                                 x.shape[:-1], k, dtype)
            assert torch.equal(got_i, want_i.to(torch.int8))
            assert torch.equal(_bits(got_v),
                               _bits(torch.gather(xh, -1, want_i).to(dtype)))


def _three_part_rotation(x, p):
    """x . P as the kernel computes it: P split into bf16 hi, mid, lo; for
    each k-step of 16 and each part in that order, the f32 accumulator
    takes the step's product."""
    hi = p.bfloat16().float()
    r = p - hi
    mid = r.bfloat16().float()
    lo = (r - mid).bfloat16().float()
    xf = x.float()
    acc = torch.zeros(*x.shape[:-1], p.shape[-1])
    with f32_matmul():
        for k0 in range(0, x.shape[-1], 16):
            for part in (hi, mid, lo):
                acc = acc + torch.einsum("bjsd,jde->bjse", xf[..., k0:k0 + 16],
                                         part[:, k0:k0 + 16])
    return acc, hi + mid + lo


@pytest.mark.parametrize("dh", [80, 128])
def test_three_bf16_parts_keep_f32_accuracy(dh):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 2, 256, dh)).astype(
        np.float32)).bfloat16()
    p = _orthogonal(rng, 2, dh)
    got, p3 = _three_part_rotation(x, p)
    # the parts carry P to 2^-24 of each entry: f32's own resolution
    assert bool(((p3.double() - p.double()).abs()
                 <= 2.0 ** -24 * p.double().abs()).all())
    want = _x_hat(x, p)
    scale = torch.einsum("bjsd,jde->bjse", x.float().abs(), p.abs())
    err = (got - want).abs()
    assert bool((err <= 2.0 ** -20 * scale).all()), err.max()
    # two parts (16 bits) miss that bound
    two = torch.einsum("bjsd,jde->bjse", x.float(),
                       p.bfloat16().float() + (p - p.bfloat16().float())
                       .bfloat16().float())
    assert bool(((two - want).abs() > 2.0 ** -20 * scale).any())
    # the selection: the twin's idx on every vector clear of near-ties
    k = dh // 2
    _, want_i = spk.swan_prune_plain(x, p, k)
    _, got_i = _emulate(got, k, x.dtype)
    srt = want.abs().sort(-1, descending=True).values
    clear = ((srt[..., :k] - srt[..., 1:k + 1]).amin(-1) > 1e-5 * srt[..., 0])
    assert bool(clear.float().mean() > 0.5)
    assert bool((got_i == want_i).all(-1)[clear].all())


@pytest.mark.parametrize("x_bytes", [2, 4])
def test_precheck_budgets_the_kernel_layout(x_bytes):
    """The CUDA source's layout: P (three bf16 parts of [128][136], or f32
    [128][128]), two x tiles of 64 rows padded by 16 bytes, two f32 x̂
    tiles [64][136]."""
    p = 3 * D * (D + 8) * 2 if x_bytes == 2 else D * D * 4
    want = p + 2 * 64 * (D * x_bytes + 16) + 2 * 64 * (D + 8) * 4
    assert spk.smem_bytes(x_bytes) == want
    for dh, k in ((128, 64), (80, 7), (16, 16)):
        rep = spk.precheck(dh=dh, k_max=k, x_bytes=x_bytes)
        assert rep == {"errors": [], "smem_bytes": want}
    assert want <= spk.SMEM_PER_BLOCK
