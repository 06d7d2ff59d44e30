"""The ``encdec`` family in the port against the JAX package, on the
whisper-small smoke config (an encoder over 32 stub frames, a decoder with
self- and cross-attention, learned positions, LayerNorm, GELU MLP, every
bias flag) at float32, with the reference's weights and projections
carried across.  Every bias (q/k/v, attention output, MLP; encoder,
decoder and cross-attention) is set to seeded non-zero values in the
reference's params before anything runs.

Checked: the config fields and the init tree, ``make_batch`` bit for bit,
the encoder's output, the forward logits and the loss, one training step's
loss and gradients, calibration and absorption, prefill and decode logits
over dense, SWAN, int8 and ``compress_cross_attn`` caches, greedy lockstep
tokens against the reference's session, the cross cache winnowed at full
retention against the uncompressed one (the reference's own test,
``tests/test_elastic_and_extensions.py:61-85``), the engine's refusal, and
both launchers on the CPU.  One reference pipeline is shared by the
module."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import OptimizerConfig as JOpt  # noqa: E402
from repro.configs import SwanConfig as JSwan  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch.io import make_batch as j_make_batch  # noqa: E402
from repro.models import encdec as j_encdec  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.optim.adamw import init_opt_state as j_init_opt  # noqa: E402
from repro.runtime.serve_loop import ServeSession as JSession  # noqa: E402
from repro.runtime.serve_loop import calibrate_swan as j_calibrate  # noqa: E402
from repro.runtime.train_loop import make_train_step as j_train_step  # noqa: E402
from repro_torch.configs import (OptimizerConfig, SwanConfig,  # noqa: E402
                                 get_config, get_smoke_config)
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core import projections as tproj  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.io import make_batch  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.optim.adamw import init_opt_state  # noqa: E402
from repro_torch.runtime.serve_engine import ServeEngine  # noqa: E402
from repro_torch.runtime.serve_loop import ServeSession, calibrate_swan  # noqa: E402
from repro_torch.runtime.train_loop import make_train_step  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves, unflatten  # noqa: E402

ARCH = "whisper-small"
F32 = dict(dtype="float32", param_dtype="float32")
TOL = 5e-5                              # tests/test_kernels.py:28
# int8 values: a ~1e-7 difference in an f32 vector before quantization can
# flip one level of round(v / scale) at a rounding edge, which moves the
# logits by up to a few 1e-4 (tests/test_torch_vlm_family.py measures it);
# int8 caches' logits are held to 2e-3
INT8_TOL = 2e-3
BIAS_STD = 0.1
BIASES = ("bq", "bk", "bv", "bo", "b_up", "b_down")
# cache kind -> SwanConfig keywords (None: the dense cache)
CACHES = {"dense": None, "swan": dict(k_max=8, buffer=4),
          "int8": dict(k_max=8, buffer=4, quantize=True),
          "cross": dict(k_max=8, buffer=4, compress_cross_attn=True),
          "cross_int8": dict(k_max=8, buffer=4, compress_cross_attn=True,
                             quantize=True),
          "cross_fp8": dict(k_max=8, buffer=4, compress_cross_attn=True,
                            quantize=True, quant_dtype="fp8"),
          "cross_truncate": dict(k_max=8, buffer=4, compress_cross_attn=True,
                                 mode="truncate")}
_REF = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: hundreds of tiny eager ops, which extra threads
    only slow down when the suite's workers share the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _with_biases(tree, rng):
    """``tree`` with every bias leaf drawn from N(0, BIAS_STD) in place of
    its zeros, in sorted key order (one rng stream)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out[k] = _with_biases(v, rng)
        elif k in BIASES:
            out[k] = jnp.asarray(rng.normal(0.0, BIAS_STD, v.shape)
                                 .astype(np.float32))
        else:
            out[k] = v
    return out


def _ref():
    """The reference's f32 smoke pipeline (weights with non-zero biases,
    calibration, absorption), its tensors in torch, and a cache of its
    runs."""
    if not _REF:
        jcfg = j_smoke(ARCH).replace(**F32)
        japi = j_get_model(jcfg)
        params = _with_biases(japi.init_params(jax.random.PRNGKey(0), jcfg),
                              np.random.default_rng(0))
        pj = j_calibrate(japi, jcfg, params, j_make_batch(jcfg, 2, 24, seed=3))
        absorbed = japi.absorb(params, jcfg, pj)
        _REF.update({
            "jcfg": jcfg, "tcfg": get_smoke_config(ARCH).replace(**F32),
            "params": params, "absorbed": absorbed, "pj": pj,
            "t": {n: to_torch(x, device="cpu") for n, x in
                  (("params", params), ("absorbed", absorbed), ("pj", pj))}})
    return _REF


# ---------------------------------------------------------------------------
# configs, init, batches
# ---------------------------------------------------------------------------

def test_config_fields_match_reference():
    for mine, theirs in ((get_config(ARCH), j_config(ARCH)),
                         (get_smoke_config(ARCH), j_smoke(ARCH))):
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
        assert mine.n_params() == theirs.n_params()
        assert mine.max_position_learned() == theirs.max_position_learned()
    assert SwanConfig().compress_cross_attn is JSwan().compress_cross_attn


def test_init_tree_matches_reference():
    """The port's own init has the reference's tree (the enc/dec subtrees,
    both positional tables, the cross-attention and every bias), shapes
    and dtypes (bf16)."""
    cfg, jcfg = get_smoke_config(ARCH), j_smoke(ARCH)
    jp = to_torch(j_get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg),
                  device="cpu")
    tp = get_model(cfg).init_params(cfg, 0, "cpu")
    assert [(p, tuple(x.shape), x.dtype) for p, x in flatten_with_path(tp)] \
        == [(p, tuple(x.shape), x.dtype) for p, x in flatten_with_path(jp)]
    assert tuple(tp["dec"]["pos_embed"].shape) == (1 << 16, cfg.d_model)
    assert tuple(tp["enc"]["pos_embed"].shape) == (cfg.encoder_seq,
                                                   cfg.d_model)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_make_batch_bit_for_bit(dtype):
    """Tokens, then the frame embeddings, from one ``default_rng`` stream,
    rounded to the dtype as the reference rounds them."""
    jb = j_make_batch(j_smoke(ARCH).replace(dtype=dtype), 3, 11, seed=7)
    tb = make_batch(get_smoke_config(ARCH).replace(dtype=dtype), 3, 11,
                    seed=7, device="cpu")
    assert sorted(tb) == sorted(jb) == ["frames", "tokens"]
    assert torch.equal(tb["tokens"], torch.as_tensor(
        np.array(jb["tokens"]), dtype=torch.int64))
    got = tb["frames"]
    assert got.dtype == getattr(torch, dtype) and got.shape == (3, 32, 64)
    assert torch.equal(got, to_torch(jb["frames"], device="cpu"))


# ---------------------------------------------------------------------------
# forward, loss, training step, calibration
# ---------------------------------------------------------------------------

def test_encoder_forward_and_loss_match_reference():
    r = _ref()
    jcfg, tcfg = r["jcfg"], r["tcfg"]
    jb = j_make_batch(jcfg, 2, 20, seed=1)
    tb = make_batch(tcfg, 2, 20, seed=1, device="cpu")
    np.testing.assert_allclose(
        encdec.encode(r["t"]["params"], tcfg, tb["frames"]).numpy(),
        np.asarray(j_encdec.encode(r["params"], jcfg, jb["frames"])),
        atol=TOL, rtol=0)
    japi, api = j_get_model(jcfg), get_model(tcfg)
    jl, _ = japi.forward(r["params"], jcfg, jb)
    tl = api.forward(r["t"]["params"], tcfg, tb)
    assert tl.shape == (2, 20, tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    jloss, jparts = japi.loss(r["params"], jcfg, jb)
    tloss, tparts = api.loss(r["t"]["params"], tcfg, tb)
    for a, b in ((tloss, jloss), (tparts["nll"], jparts["nll"]),
                 (tparts["z"], jparts["z"])):
        np.testing.assert_allclose(float(a), float(b), atol=TOL, rtol=0)


def test_train_step_matches_reference():
    """One optimizer step on a batch with frames: the loss and every
    gradient (encoder, decoder, cross-attention, positional tables,
    biases)."""
    r = _ref()
    jcfg, tcfg = r["jcfg"], r["tcfg"]
    jb = j_make_batch(jcfg, 4, 17, seed=5)
    tb = make_batch(tcfg, 4, 17, seed=5, device="cpu")
    opt = dict(lr=1e-2, warmup_steps=1, decay_steps=5)
    jp = r["params"]
    _, _, jm = j_train_step(jcfg, JOpt(**opt))(
        jp, j_init_opt(jp, JOpt(**opt)), jb)
    tp = to_torch(jp, device="cpu")
    flat = [x.detach().requires_grad_() for x in leaves(tp)]
    loss, _ = get_model(tcfg).loss(unflatten(tp, flat), tcfg, tb)
    tg = torch.autograd.grad(loss, flat)
    japi = j_get_model(jcfg)
    jg = jax.grad(lambda p: japi.loss(p, jcfg, jb)[0])(jp)
    # a key bias's gradient is zero in exact arithmetic (it shifts every
    # score of a query by the same amount), so both packages return
    # rounding noise (~1e-10) there: those leaves are held to be zero
    # within a millionth of the largest gradient, the others to 1e-4 of
    # their own largest gradient
    jl = [np.asarray(b) for b in jax.tree_util.tree_leaves(jg)]
    noise = 1e-6 * max(float(np.max(np.abs(b))) for b in jl)
    for (path, _), a, b in zip(flatten_with_path(tp), tg, jl):
        if path.endswith("/bk"):
            assert max(np.max(np.abs(b)), a.abs().max().item()) <= noise, path
        else:
            assert np.max(np.abs(a.numpy() - b)) <= 1e-4 * np.max(np.abs(b)), \
                path
    _, _, tm = make_train_step(tcfg, OptimizerConfig(**opt))(
        tp, init_opt_state(tp, OptimizerConfig(**opt)), tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=TOL, rtol=0)


def test_calibration_and_absorption_match_reference():
    """The port's calibration of the decoder self-attention: orthogonal
    projections with the reference's spectra; absorbing them is lossless;
    absorbing the reference's gives its weights."""
    r = _ref()
    tcfg = r["tcfg"]
    api = get_model(tcfg)
    tparams = r["t"]["params"]
    tpj = calibrate_swan(api, tcfg, tparams,
                         make_batch(tcfg, 2, 24, seed=3, device="cpu"))
    for name in ("p_qk", "p_vo"):
        assert tuple(tpj[name].shape) == (2, 4, 16, 16)
        assert tproj.check_orthogonal(tpj[name]) < 1e-4
        spec = name.replace("p_", "spectrum_")
        np.testing.assert_allclose(tpj[spec].numpy(), np.asarray(r["pj"][spec]),
                                   rtol=1e-3, atol=1e-3)
    tb = make_batch(tcfg, 2, 20, seed=9, device="cpu")
    np.testing.assert_allclose(
        api.forward(api.absorb(tparams, tcfg, tpj), tcfg, tb).numpy(),
        api.forward(tparams, tcfg, tb).numpy(), atol=TOL)
    t_abs = api.absorb(tparams, tcfg, r["t"]["pj"])
    for n in ("wv", "wo", "bv", "bo"):
        np.testing.assert_allclose(
            t_abs["dec"]["layers"]["attn"][n].numpy(),
            np.asarray(r["absorbed"]["dec"]["layers"]["attn"][n]), atol=TOL)
    assert t_abs["enc"] is tparams["enc"]
    assert t_abs["dec"]["layers"]["cross"] is tparams["dec"]["layers"]["cross"]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _api_run(api, cfg, weights, swan, proj, batch, steps):
    """Prefill ``batch`` (frames and tokens), then ``steps`` greedy decode
    steps.  Returns the logits of each call [steps + 1, B, V], the tokens
    and the state."""
    is_torch = cfg.__class__.__module__.startswith("repro_torch")
    B, T = batch["tokens"].shape
    kw = {"device": "cpu"} if is_torch else {}
    state = api.init_serve_state(cfg, swan, B, 32, **kw)
    logits, state = api.prefill(weights, cfg, batch, state, swan, proj)
    logits = logits[:, -1]
    out, toks = [np.asarray(logits, np.float32)], []
    for i in range(steps):
        tok = (torch.argmax(logits, -1) if is_torch
               else jnp.argmax(logits, -1))
        toks.append(np.asarray(tok))
        logits, state = api.decode_step(weights, cfg, tok, T + i, state,
                                        swan, proj)
        out.append(np.asarray(logits, np.float32))
    return np.stack(out), np.stack(toks, 1), state


def _weights(r, sw):
    if sw is None:
        return (r["params"], None, None), (r["t"]["params"], None, None)
    return ((r["absorbed"], JSwan(**sw), r["pj"]),
            (r["t"]["absorbed"], SwanConfig(**sw), r["t"]["pj"]))


@pytest.mark.parametrize("cache", list(CACHES))
def test_prefill_and_decode_logits_match_reference(cache):
    """The model API of both packages: prefill logits and 4 greedy decode
    steps within 5e-5 (int8 values: ``INT8_TOL``), and the cross cache
    the prefill built (dense or winnowed) equal leaf by leaf."""
    r = _ref()
    jcfg, tcfg = r["jcfg"], r["tcfg"]
    (jw, jsw, jpj), (tw, tsw, tpj) = _weights(r, CACHES[cache])
    want, jt, jstate = _api_run(j_get_model(jcfg), jcfg, jw, jsw, jpj,
                                j_make_batch(jcfg, 2, 10, seed=1), 4)
    got, tt, tstate = _api_run(get_model(tcfg), tcfg, tw, tsw, tpj,
                               make_batch(tcfg, 2, 10, seed=1, device="cpu"),
                               4)
    tol = INT8_TOL if "int8" in cache else TOL
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    np.testing.assert_array_equal(tt, jt)
    for side in ("k", "v"):
        jc, tc = jstate["cross"][side], tstate["cross"][side]
        assert isinstance(tc, dict) == isinstance(jc, dict)
        for leaf, t in (tc.items() if isinstance(tc, dict) else [("", tc)]):
            j = np.asarray(jc[leaf] if leaf else jc).astype(np.float32)
            t = t.float().numpy()
            if leaf == "idx":
                # top-k ties of equal magnitude are the only freedom
                assert (t != j).mean() < 1e-3, leaf
            else:
                np.testing.assert_allclose(t, j, atol=tol if leaf != "vals"
                                           or "int8" not in cache else 1,
                                           rtol=0, err_msg=f"{side}/{leaf}")


@pytest.mark.parametrize("cache", ["dense", "swan", "cross"])
def test_lockstep_tokens_match_reference_session(cache):
    """The reference's session is right for an encoder-decoder (the frames
    take no decoder positions): greedy tokens equal, and the cache
    reports."""
    r = _ref()
    jcfg, tcfg = r["jcfg"], r["tcfg"]
    (jw, jsw, jpj), (tw, tsw, tpj) = _weights(r, CACHES[cache])
    jsess = JSession(jcfg, jw, swan=jsw, projections=jpj, max_seq=32,
                     batch=2)
    tsess = ServeSession(tcfg, tw, swan=tsw, projections=tpj, max_seq=32,
                         batch=2, device="cpu")
    j_out = jsess.generate(j_make_batch(jcfg, 2, 10, seed=2), 12)
    t_out = tsess.generate(make_batch(tcfg, 2, 10, seed=2, device="cpu"), 12)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    assert tsess.pos == jsess.pos == 10 + 11
    assert tsess.cache_report() == jsess.cache_report()


def test_compressed_cross_cache_is_lossless_at_full_retention():
    """The reference's own check (``tests/test_elastic_and_extensions.py
    :61-85``) on the port: at k = d_head the winnowed cross cache gives the
    uncompressed cache's decode logits within 2e-4; at k = d_head / 2 it
    runs without NaN; and both agree with the reference's."""
    r = _ref()
    jcfg, tcfg = r["jcfg"], r["tcfg"]
    api, japi = get_model(tcfg), j_get_model(jcfg)
    tb = make_batch(tcfg, 2, 10, seed=0, device="cpu")
    jb = j_make_batch(jcfg, 2, 10, seed=0)

    def serve(compress, k, torch_side=True):
        if torch_side:
            sw = SwanConfig(k_max=k, buffer=4, compress_cross_attn=compress)
            st = api.init_serve_state(tcfg, sw, 2, 24, device="cpu")
            lg, st = api.prefill(r["t"]["absorbed"], tcfg, tb, st, sw,
                                 r["t"]["pj"])
            lg2, _ = api.decode_step(r["t"]["absorbed"], tcfg,
                                     torch.argmax(lg[:, -1], -1), 10, st, sw,
                                     r["t"]["pj"])
            return lg2.numpy()
        sw = JSwan(k_max=k, buffer=4, compress_cross_attn=compress)
        st = japi.init_serve_state(jcfg, sw, 2, 24)
        lg, st = japi.prefill(r["absorbed"], jcfg, jb, st, sw, r["pj"])
        lg2, _ = japi.decode_step(r["absorbed"], jcfg,
                                  jnp.argmax(lg[:, -1], -1), 10, st, sw,
                                  r["pj"])
        return np.asarray(lg2)

    dh = tcfg.d_head
    full, full_cc = serve(False, dh), serve(True, dh)
    np.testing.assert_allclose(full, full_cc, atol=2e-4, rtol=1e-3)
    comp = serve(True, dh // 2)
    assert not np.isnan(comp).any()
    np.testing.assert_allclose(comp, serve(True, dh // 2, torch_side=False),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(full_cc, serve(True, dh, torch_side=False),
                               atol=TOL, rtol=0)


def test_engine_refuses_encoder_decoder():
    """As the reference's engine: the requests carry no frames."""
    r = _ref()
    with pytest.raises(NotImplementedError, match="encoder frames"):
        ServeEngine(r["tcfg"], r["t"]["params"], device="cpu")


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress", [False, True])
def test_serve_launcher_runs_lockstep_on_cpu(compress, capsys, monkeypatch):
    """Lockstep serving (with the cross cache winnowed when the launcher's
    SwanConfig asks for it); ``--engine`` is refused as by the
    reference."""
    argv = ["--arch", ARCH, "--smoke", "--swan", "--k", "8", "--buffer", "4",
            "--tokens", "3", "--batch", "2", "--prompt-len", "12",
            "--max-seq", "64", "--device", "cpu"]
    if compress:
        real = serve_cli.SwanConfig
        monkeypatch.setattr(serve_cli, "SwanConfig", lambda **kw: real(
            compress_cross_attn=True, **kw))
    sess = serve_cli.main(argv)
    assert "cache [swan[topk]]" in capsys.readouterr().out
    assert sess.pos == 12 + 2
    assert isinstance(sess.state["cross"]["k"], dict) == compress
    with pytest.raises(NotImplementedError, match="ServeSession"):
        serve_cli.main(argv + ["--engine"])


def test_train_launcher_refuses_on_cpu(tmp_path):
    """The token stream carries no frames: the port refuses where the
    reference's trainer fails (``KeyError: 'frames'``)."""
    with pytest.raises(SystemExit, match="encoder frames"):
        train_cli.main(["--arch", ARCH, "--smoke", "--steps", "3",
                        "--batch", "2", "--seq", "16", "--ckpt-dir",
                        str(tmp_path), "--device", "cpu"])
