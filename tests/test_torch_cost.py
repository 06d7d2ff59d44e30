"""The port's per-step cost analyzer (``repro_torch.analysis.cost``) against
the reference's HLO analyzer (``repro.analysis.hlo``): dot flops from
shapes, a Python loop counted per iteration where the reference multiplies
by the trip count, byte counts per dtype width, host transfers counted
once per boundary, a step without one; the llama3-8b smoke decode and
prefill steps (float32, the reference's weights carried across) with their
matmul flops summed by hand from the shapes and their total flops held to
``analyze_hlo`` of the reference's jitted steps; and the kernel wrappers'
launch reports."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis.hlo import analyze_hlo, transfer_stats  # noqa: E402
from repro.configs import SwanConfig as JSwan  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch.io import make_batch as j_make_batch  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.runtime.serve_loop import calibrate_swan as j_calibrate  # noqa: E402
from repro_torch.analysis import roofline as rl  # noqa: E402
from repro_torch.analysis.cost import (CostMode, StepCosts,  # noqa: E402
                                       analyze_step, is_host_copy)
from repro_torch.configs import SwanConfig, get_smoke_config  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
B, S, MAX_SEQ, K, BUF = 2, 16, 64, 8, 4
# the total-flop tolerance against analyze_hlo: XLA lowers some aten ops
# to several counted HLO ops (silu = logistic + multiply, a mean = reduce +
# divide, rope's and the norms' broadcasts), which the port counts as one
# op or none; the matmuls, 92-98 % of the flops, agree exactly
FLOP_TOL = 0.05
_REF = {}


def _hlo(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


# ---------------------------------------------------------------------------
# Synthetic functions (exact)
# ---------------------------------------------------------------------------

def test_dot_flops_from_shapes():
    a, b = np.ones((64, 128), np.float32), np.ones((128, 32), np.float32)
    c = analyze_step(lambda x, y: x @ y, torch.from_numpy(a),
                     torch.from_numpy(b))
    ref = analyze_hlo(_hlo(lambda x, y: x @ y, a, b))
    assert c.flops == c.flops_of("matmul") == 2 * 64 * 128 * 32
    assert ref.flops == c.flops
    # operands read once, the result written once
    assert c.hbm_bytes == (64 * 128 + 128 * 32 + 64 * 32) * 4


def test_einsum_and_linear_lower_to_counted_products():
    x, w = torch.randn(3, 5, 8), torch.randn(8, 6)
    e = analyze_step(lambda x, w: torch.einsum("bsd,de->bse", x, w), x, w)
    lin = analyze_step(torch.nn.functional.linear, x, w.t())
    assert e.flops_of("matmul") == lin.flops_of("matmul") == 2 * 15 * 8 * 6


def test_loop_counted_per_iteration():
    x = torch.randn(64, 64)
    ws = [torch.randn(64, 64) for _ in range(12)]

    def loop(x, ws):
        for w in ws:
            x = x @ w
        return x.sum()
    one = analyze_step(lambda x, w: (x @ w).sum(), x, ws[0])
    many = analyze_step(loop, x, ws)
    assert many.flops_of("matmul") == 12 * one.flops_of("matmul")
    # the reference reaches the same count through the scan's trip count
    xs = jax.ShapeDtypeStruct((64, 64), jnp.float32)
    wn = jax.ShapeDtypeStruct((12, 64, 64), jnp.float32)

    def scanned(x, ws):
        x, _ = jax.lax.scan(lambda x, w: (x @ w, None), x, ws)
        return jnp.sum(x)
    ref = analyze_hlo(jax.jit(scanned).lower(xs, wn).compile().as_text())
    assert abs(ref.flops - many.flops) / many.flops < 0.05


@pytest.mark.parametrize("dtype,width", [(torch.int8, 1), (torch.bfloat16, 2),
                                         (torch.float32, 4)])
def test_bytes_follow_dtype_width(dtype, width):
    t = torch.ones((64, 128), dtype=dtype)
    c = analyze_step(lambda t: t + t, t)
    assert c.hbm_bytes == 3 * 64 * 128 * width            # 2 reads, 1 write


def test_fp8_cast_bytes():
    t = torch.ones((64, 128))
    c = analyze_step(lambda t: t.to(torch.float8_e4m3fn), t)
    assert c.hbm_bytes == 64 * 128 * (4 + 1)
    assert c.flops == 0                      # a convert is not arithmetic


def test_views_free_and_inplace_read_once_written_once():
    x = torch.randn(32, 16)
    c = analyze_step(lambda x: x.view(16, 32).t()[:4].unsqueeze(0), x)
    assert c.hbm_bytes == 0 and c.ops
    c = analyze_step(lambda x: x.t().reshape(-1), x)     # a real copy
    assert c.hbm_bytes == 2 * 32 * 16 * 4
    c = analyze_step(lambda x: x.add_(1.0), x)
    assert c.hbm_bytes == 2 * 32 * 16 * 4 and c.flops == 32 * 16
    dst = torch.empty(32, 16)
    c = analyze_step(lambda d, s: d.copy_(s), dst, x)
    assert c.hbm_bytes == 2 * 32 * 16 * 4    # src read, dst only written


def test_gather_and_scatter_touch_their_region_only():
    big = torch.randn(1000, 64)
    idx = torch.tensor([3, 7, 11])
    c = analyze_step(lambda x, i: x[i], big, idx)
    assert c.hbm_bytes == 2 * 3 * 64 * 4                  # 2 x result
    upd = torch.ones(3, 64)
    c = analyze_step(lambda x, i, u: x.index_put_((i,), u), big, idx, upd)
    assert c.hbm_bytes == 3 * 3 * 64 * 4                  # 3 x updates
    o = torch.zeros(4, 16)
    src, where = torch.ones(4, 5), torch.randint(0, 16, (4, 5))
    c = analyze_step(lambda o, w, s: o.scatter_add_(-1, w, s), o, where, src)
    assert c.hbm_bytes == 3 * 4 * 5 * 4


def test_reduction_counts_its_input():
    c = analyze_step(lambda x: x.sum(-1), torch.randn(8, 100))
    assert c.flops == 800


def test_host_transfers_counted_once_per_boundary():
    x = torch.randn(16)

    def f(x):
        y = x * 2 + 1                        # device traffic: not counted
        a = y.sum().item()
        b = int(y.argmax())
        return a + b + float(y.max())
    c = analyze_step(f, x)
    assert c.host_transfers == 3
    assert [o.name for o in c.ops if o.kind == "transfer"] == \
        ["_local_scalar_dense"] * 3
    # a copy from a device tensor to the CPU is one transfer; a copy that
    # stays on one device is none (meta stands in for the card here)
    dev, host = torch.empty(4, device="meta"), torch.empty(4)
    assert is_host_copy("copy_", (host, dev), {}, host)
    assert is_host_copy("_to_copy", (dev,), {"device": "cpu"}, host)
    assert not is_host_copy("copy_", (host, torch.empty(4)), {}, host)
    assert not is_host_copy("copy_", (dev, host), {}, dev)


def test_step_without_host_transfer():
    x = np.ones((64, 64), np.float32)
    c = analyze_step(lambda x: torch.tanh(x) @ x, torch.from_numpy(x))
    ts = transfer_stats(_hlo(lambda x: jnp.tanh(x) @ x, x))
    assert c.host_transfers == ts.host_total == 0
    assert c.collective_count == 0 and not c.per_collective


def _fake_kernels():
    """The decode and chunk kernels' cost hooks on fresh ``CudaKernel``s:
    ``count_launch`` counts and reports without a card (nothing builds)."""
    from repro_torch.kernels.build import CudaKernel
    from repro_torch.kernels.swan_chunk import swan_chunk as sc
    from repro_torch.kernels.swan_decode import swan_decode as sd
    return (CudaKernel("swan_decode", sd.LIBRARY, sd.launch_cost),
            CudaKernel("swan_chunk_stats", sc.LIBRARY, sc.launch_cost))


def test_kernel_report_adds_the_roofline_cost_only_under_an_analyzer():
    dec, chunk = _fake_kernels()
    q = torch.zeros(4, 8, 4, 128, dtype=torch.bfloat16)
    vals = torch.zeros(4, 8, 4096, 64, dtype=torch.bfloat16)
    ring = torch.zeros(4, 8, 128, 128, dtype=torch.bfloat16)
    full = torch.full((4,), 4096, dtype=torch.int32)
    nbytes = rl.swan_decode_kernel_bytes(
        B=4, Kv=8, G=4, dh=128, S=4096, k_max=64, buffer=128,
        quantized=False, val_bytes=2, act_bytes=2)
    flops = rl.swan_decode_kernel_flops(B=4, Kv=8, G=4, dh=128, S=4096,
                                        k_max=64, buffer=128)
    assert dec.cost(q, vals, ring, full, 4096) == (flops, nbytes)
    dec.count_launch(q, vals, ring, full, 4096)     # no analyzer: counted only
    assert dec.launches == 1
    qc, vc, lc = torch.zeros(2, 8, 1024, 128), vals[:2], full[:2]
    with CostMode() as mode:
        dec.count_launch(q, vals, ring, full, 4096)           # a fake launch
        with mode.paused():
            dec.count_launch(q, vals, ring, full, 4096)  # paused: uncounted
        chunk.count_launch(qc, vc, lc, 4096)
    assert dec.launches == 3 and chunk.launches == 1
    c = mode.costs
    assert c.kernel_launches == {"swan_decode": 1, "swan_chunk_stats": 1}
    assert c.hbm_bytes == nbytes + rl.swan_chunk_kernel_bytes(
        B=2, Kv=8, Q=1024, dh=128, S=4096, k_max=64, quantized=False,
        val_bytes=2)
    assert c.flops_of("kernel") == c.flops
    # the hook's own read of sp_len is neither counted nor a transfer
    assert c.host_transfers == 0 and len(c.ops) == 2


@pytest.mark.parametrize("which", ["decode", "chunk"])
def test_kernel_cost_follows_the_rows_it_reads(which):
    """A launch is charged the packed rows the kernel reads, min(sp_len,
    S) per sequence, not the allocation's S: sp_len = S/2 halves the packed
    bytes and flops; other lengths count row by row."""
    dec, chunk = _fake_kernels()
    S, B = 4096, 4
    vals = torch.zeros(B, 8, S, 64, dtype=torch.bfloat16)
    if which == "decode":
        q = torch.zeros(B, 8, 4, 128, dtype=torch.bfloat16)
        ring = torch.zeros(B, 8, 128, 128, dtype=torch.bfloat16)
        kern, args = dec, (q, vals, ring)
    else:
        kern, args = chunk, (torch.zeros(B, 8, 256, 128), vals)

    def launch_args(lens):
        sp = torch.tensor(lens, dtype=torch.int32)
        if which == "decode":
            return (args[0], vals, args[2], sp, S)
        return (args[0], vals, sp, S)

    def cost(lens):
        return kern.cost(*launch_args(lens))
    fixed = np.array(cost([0] * B))         # q, ring and outputs only
    packed = np.array(cost([S] * B)) - fixed
    half = np.array(cost([S // 2] * B)) - fixed
    assert (packed > 0).all() and (half * 2 == packed).all()
    # min(max(sp_len, 0), S) rows per sequence: 4096 + 0 + 1024 + 4096
    mixed = np.array(cost([S, -3, S // 4, S + 500])) - fixed
    assert (mixed * 16 == packed * 9).all()
    with CostMode() as mode:
        kern.count_launch(*launch_args([S // 2] * B))
    assert mode.costs.hbm_bytes == half[1] + fixed[1]
    assert mode.costs.flops == half[0] + fixed[0]


def test_stepcosts_json_has_the_reference_fields():
    from repro.analysis.hlo import HloCosts
    import dataclasses
    ref = {f.name for f in dataclasses.fields(HloCosts)}
    assert ref <= set(StepCosts().to_json())


# ---------------------------------------------------------------------------
# The llama3-8b smoke steps against the reference's jitted steps
# ---------------------------------------------------------------------------

def _ref():
    """The reference's f32 llama3-8b smoke pipeline, its jitted prefill and
    decode costs (analyze_hlo), and the port's costs of the same steps on
    the same weights and tokens."""
    if not _REF:
        jcfg = j_smoke("llama3-8b").replace(**F32)
        japi = j_get_model(jcfg)
        params = japi.init_params(jax.random.PRNGKey(0), jcfg)
        pj = j_calibrate(japi, jcfg, params, j_make_batch(jcfg, 2, 24, seed=3))
        ab = japi.absorb(params, jcfg, pj)
        jsw = JSwan(k_max=K, buffer=BUF)
        toks = np.random.RandomState(1).randint(0, jcfg.vocab_size, (B, S))
        jt = jnp.asarray(toks, jnp.int32)
        pre = jax.jit(lambda p, t, s: japi.prefill(p, jcfg, {"tokens": t}, s,
                                                   jsw, pj))
        st = japi.init_serve_state(jcfg, jsw, B, MAX_SEQ)
        h_pre = analyze_hlo(pre.lower(ab, jt, st).compile().as_text())
        _, st = pre(ab, jt, st)
        dec = jax.jit(lambda p, t, pos, s: japi.decode_step(p, jcfg, t, pos,
                                                            s, jsw, pj))
        h_dec = analyze_hlo(dec.lower(ab, jt[:, -1], S, st).compile()
                            .as_text())

        cfg = get_smoke_config("llama3-8b").replace(**F32)
        api = get_model(cfg)
        tp, tpj = to_torch(ab, device="cpu"), to_torch(pj, device="cpu")
        sw = SwanConfig(k_max=K, buffer=BUF)
        ts = api.init_serve_state(cfg, sw, B, MAX_SEQ, "cpu")
        tt = torch.from_numpy(toks.astype(np.int64))
        c_pre = analyze_step(api.prefill, tp, cfg, {"tokens": tt}, ts, sw, tpj)
        c_dec = analyze_step(api.decode_step, tp, cfg, tt[:, -1], S, ts, sw,
                             tpj)
        _REF.update(cfg=cfg, h_pre=h_pre, h_dec=h_dec, c_pre=c_pre,
                    c_dec=c_dec)
    return _REF


def _layer_products(cfg, rows: int) -> int:
    """2·M·N·K of one layer's weight products over ``rows`` tokens: q, k,
    v, the rotations of q and k by P_QK, o, and the gated MLP."""
    d, H, Kv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                       cfg.d_ff)
    return 2 * rows * (d * H * dh + 2 * d * Kv * dh + H * dh * dh
                       + Kv * dh * dh + H * dh * d + 3 * d * f)


def test_decode_matmul_flops_equal_the_shapes():
    r = _ref()
    cfg = r["cfg"]
    # the ring's scores and values (G queries over b slots of dh; the
    # plain path reads the packed prefix by gather and scatter, not by a
    # product) and the head over the new token
    ring = 2 * 2 * B * cfg.n_heads * BUF * cfg.d_head
    want = (cfg.n_layers * (_layer_products(cfg, B) + ring)
            + 2 * B * cfg.d_model * cfg.vocab_size)
    assert r["c_dec"].flops_of("matmul") == want


def test_prefill_matmul_flops_equal_the_shapes():
    r = _ref()
    cfg = r["cfg"]
    # dense causal attention over the prompt (scores and values, the full
    # S x S square), the head at the last position
    attn = 2 * 2 * B * cfg.n_heads * S * S * cfg.d_head
    want = (cfg.n_layers * (_layer_products(cfg, B * S) + attn)
            + 2 * B * cfg.d_model * cfg.vocab_size)
    assert r["c_pre"].flops_of("matmul") == want


@pytest.mark.parametrize("step", ["pre", "dec"])
def test_total_flops_within_tolerance_of_analyze_hlo(step):
    r = _ref()
    h, c = r[f"h_{step}"], r[f"c_{step}"]
    gap = c.flops / h.flops - 1.0
    print(f"{step}: port {c.flops:.0f} flops (matmul "
          f"{c.flops_of('matmul'):.0f}) vs analyze_hlo {h.flops:.0f}: gap "
          f"{gap:+.4f} (composite ops XLA lowers to several counted ops); "
          f"bytes {c.hbm_bytes:.0f} vs {h.hbm_bytes:.0f} "
          f"({c.hbm_bytes / h.hbm_bytes:.3f}x: the reference charges whole "
          "cache arrays to the fusions that update them)")
    assert abs(gap) <= FLOP_TOL
    assert c.host_transfers == h.host_transfers == 0
