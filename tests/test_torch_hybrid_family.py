"""The hybrid family (Mamba + attention + MoE) in the port against the JAX
package, on the jamba-1.5-large-398b smoke config at float32, with the
reference's weights and projections carried across.

Checked: the config fields, the layer pattern and the parameter counts,
the init tree, ``mamba_forward`` against the reference's chunked forward
and both token-level oracles (one and two chunks, channel blocks of any
size), the prefill's recurrent state against the reference's
``_mamba_state_from_prefill``, ``lm_forward`` logits and aux,
calibration and absorption over the attention layers, lockstep greedy
tokens with SWAN and without it, the engine's tokens, steps, dispatches
and cache report (monolithic on the slab, as the reference serves the
family) and its refusals, one training step's loss and gradients, a dead
lane leaving every state leaf unchanged, finite gradients at a length where
the reference's are not, and the serve launcher's tokens against the
reference's launcher on the same checkpoint.  One reference pipeline is
shared by the module."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import SwanConfig as JSwan  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import serve as j_serve_cli  # noqa: E402
from repro.launch.io import make_batch as j_make_batch  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import jamba as j_jamba  # noqa: E402
from repro.models import mamba as j_mamba  # noqa: E402
from repro.runtime.serve_engine import Request as JRequest  # noqa: E402
from repro.runtime.serve_engine import ServeEngine as JEngine  # noqa: E402
from repro.runtime.serve_loop import ServeSession as JSession  # noqa: E402
from repro.runtime.serve_loop import calibrate_swan as j_calibrate  # noqa: E402
from repro_torch.configs import (SwanConfig, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core import projections as tproj  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.io import make_batch  # noqa: E402
from repro_torch.models import jamba, mamba  # noqa: E402
from repro_torch.models.registry import get_model, swan_applicable  # noqa: E402
from repro_torch.runtime.serve_engine import Request, ServeEngine  # noqa: E402
from repro_torch.runtime.serve_loop import ServeSession, calibrate_swan  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves, unflatten  # noqa: E402

ARCH = "jamba-1.5-large-398b"
F32 = dict(dtype="float32", param_dtype="float32")
TOL = 5e-5                              # tests/test_kernels.py:28
LENS = [9, 30, 9, 20, 30, 9, 20]        # three prompt lengths
_REF = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: hundreds of tiny eager ops, which extra threads
    only slow down when the suite's workers share the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref():
    """The reference's f32 smoke pipeline (weights, calibration,
    absorption, prompts) and its tensors in torch."""
    if not _REF:
        jcfg = j_smoke(ARCH).replace(**F32)
        japi = j_get_model(jcfg)
        params = japi.init_params(jax.random.PRNGKey(0), jcfg)
        pj = j_calibrate(japi, jcfg, params, j_make_batch(jcfg, 2, 24, seed=3))
        absorbed = japi.absorb(params, jcfg, pj)
        _REF.update({
            "jcfg": jcfg, "tcfg": get_smoke_config(ARCH).replace(**F32),
            "params": params, "absorbed": absorbed, "pj": pj,
            "t": {n: to_torch(x, device="cpu") for n, x in
                  (("params", params), ("absorbed", absorbed), ("pj", pj))},
            "prompts": [np.asarray(j_make_batch(jcfg, 1, n, seed=40 + i)
                                   ["tokens"][0]).tolist()
                        for i, n in enumerate(LENS)]})
    return _REF


def _close(got, want, tol=TOL):
    """|got - want| within ``tol`` of the reference's scale (at least 1)."""
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(1.0, float(np.max(np.abs(want))))
    assert float(np.max(np.abs(got - want))) <= tol * scale


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------

def test_config_fields_match_reference():
    """Every field of the port's configs equals the reference's; the MoE
    and Mamba sub-configs field by field (the port has no
    ``shard_experts``), and the layer pattern."""
    for mine, theirs in ((get_config(ARCH), j_config(ARCH)),
                         (get_smoke_config(ARCH), j_smoke(ARCH))):
        for f in dataclasses.fields(mine):
            if f.name not in ("moe", "mamba"):
                assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
        for sub in ("moe", "mamba"):
            for f in dataclasses.fields(getattr(mine, sub)):
                assert (getattr(getattr(mine, sub), f.name)
                        == getattr(getattr(theirs, sub), f.name)), f.name
        L = mine.n_layers
        assert [mine.layer_kind(i) for i in range(L)] == \
            [theirs.layer_kind(i) for i in range(L)]
        assert [mine.ffn_kind(i) for i in range(L)] == \
            [theirs.ffn_kind(i) for i in range(L)]
        assert mine.is_attention_free is theirs.is_attention_free is False
    assert swan_applicable(get_config(ARCH))


def test_param_counts_and_the_chip_cut():
    """The reference's formula: 398.55 B for the whole model; one group of
    8 layers is 45.24 B; with 4 of its 16 routed experts, 16.247 B.  The
    reference's leaves at that cut hold 0.37 M more (16.247 B to four
    digits): the formula counts no norm scales, conv bias or Δ bias."""
    cfg = get_config(ARCH)
    assert cfg.n_params() == j_config(ARCH).n_params() == 398_551_859_200
    group = cfg.replace(n_layers=8)
    assert group.n_params() == 45_237_977_088
    cut = group.replace(moe=dataclasses.replace(cfg.moe, n_routed=4))
    assert cut.n_params() == 16_246_554_624
    # the leaves of the cut, counted from the smoke tree's shapes scaled up
    jcut = j_config(ARCH).replace(n_layers=8, moe=dataclasses.replace(
        j_config(ARCH).moe, n_routed=4))
    shapes = jax.eval_shape(lambda: j_get_model(jcut).init_params(
        jax.random.PRNGKey(0), jcut))
    d, d_in = cfg.d_model, 2 * cfg.d_model
    unformulated = (2 * 8 + 1) * d + 7 * 2 * d_in     # norms; conv_b, dt_bias
    assert sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
        shapes)) == cut.n_params() + unformulated == 16_246_923_264


def test_init_tree_matches_reference():
    """The port's own init has the reference's leaves, shapes and dtypes:
    ``groups/pos{p}`` stacked over the groups, the router, ``a_log``,
    ``dt_bias`` and ``d_skip`` in float32."""
    cfg, jcfg = get_smoke_config(ARCH), j_smoke(ARCH)     # bf16 params
    jp = jax.eval_shape(lambda: j_get_model(jcfg).init_params(
        jax.random.PRNGKey(0), jcfg))
    tp = get_model(cfg).init_params(cfg, 0, "cpu")
    assert [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in flatten_with_path(tp)] == \
        [(p, tuple(x.shape), str(x.dtype)) for p, x in flatten_with_path(jp)]
    m = tp["groups"]["pos0"]["mamba"]
    assert torch.equal(m["a_log"][0, 0], torch.log(torch.arange(1.0, 9.0)))
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001


# ---------------------------------------------------------------------------
# the Mamba block alone
# ---------------------------------------------------------------------------

def _mamba_inputs(S, seed=1):
    jcfg = j_smoke(ARCH).replace(**F32)
    p = j_mamba.init_mamba_params(jax.random.PRNGKey(seed), jcfg)
    x = (np.random.default_rng(seed).standard_normal(
        (2, S, jcfg.d_model)) * 0.5).astype(np.float32)
    return jcfg, p, x


@pytest.mark.parametrize("S", [16, 200])
def test_mamba_forward_matches_reference(S, monkeypatch):
    """One chunk (16) and two (200, a partial second chunk): the chunked
    forward against the reference's, the token-level oracle against the
    reference's, and the chunked forward against the oracle; with
    autograd on and off, and in channel blocks of one channel."""
    jcfg, p, x = _mamba_inputs(S)
    tcfg = get_smoke_config(ARCH).replace(**F32)
    tp = to_torch(p, device="cpu")
    jy = np.asarray(j_mamba.mamba_forward(p, jcfg, jnp.asarray(x)))
    jseq = np.asarray(j_mamba.mamba_reference(p, jcfg, jnp.asarray(x)))
    tx = torch.as_tensor(x)
    with torch.no_grad():
        y = mamba.mamba_forward(tp, tcfg, tx)
        seq = mamba.mamba_reference(tp, tcfg, tx)
    y_grad = mamba.mamba_forward(tp, tcfg, tx)
    monkeypatch.setattr(mamba, "INTRA_BLOCK_BYTES", 1)      # one channel
    with torch.no_grad():
        y_blocks = mamba.mamba_forward(tp, tcfg, tx)
    for got in (y, y_blocks, y_grad):
        _close(got, jy)
    _close(seq, jseq)
    # chunked vs sequential, at the reference's own test's tolerance
    # (tests/test_mamba_rwkv.py:22)
    np.testing.assert_allclose(y.numpy(), seq.numpy(), atol=1e-5)


@pytest.mark.parametrize("S", [16, 200])
def test_prefill_state_matches_reference(S):
    """The state ``mamba_forward`` returns (its own scan's final h and the
    conv tail) equals the reference's second scan, and the state a
    token-by-token decode reaches."""
    jcfg, p, x = _mamba_inputs(S, seed=2)
    tcfg = get_smoke_config(ARCH).replace(**F32)
    tp = to_torch(p, device="cpu")
    want = j_jamba._mamba_state_from_prefill(p, jcfg, jnp.asarray(x))
    with torch.no_grad():
        _, st = mamba.mamba_forward(tp, tcfg, torch.as_tensor(x),
                                    return_state=True)
        seq = mamba.init_mamba_state(tcfg, 2, "cpu")
        for t in range(S):
            mamba.mamba_decode_step(tp, tcfg, torch.as_tensor(x[:, t:t + 1]),
                                    seq)
    _close(st["h"], want["h"])
    _close(st["conv"], want["conv"])
    np.testing.assert_allclose(st["h"].numpy(), seq["h"].numpy(), atol=1e-5)
    _close(st["conv"], seq["conv"].numpy())


# ---------------------------------------------------------------------------
# the model: forward, calibration, training
# ---------------------------------------------------------------------------

def test_lm_forward_logits_and_aux():
    r = _ref()
    jb = j_make_batch(r["jcfg"], 2, 40, seed=1)
    jl, jaux = j_get_model(r["jcfg"]).forward(r["params"], r["jcfg"], jb)
    tl, taux = get_model(r["tcfg"]).forward_aux(
        r["t"]["params"], r["tcfg"], make_batch(r["tcfg"], 2, 40, seed=1,
                                                device="cpu"))
    _close(tl, jl)
    np.testing.assert_allclose(float(taux), float(jaux), atol=TOL, rtol=0)
    assert float(taux) > 0


def test_calibration_and_absorption_match_reference():
    """The attention layers' capture equals the reference's (q, k, v, wo
    stacked over the groups); the port's own calibration gives orthogonal
    projections with the reference's spectra and absorbs losslessly;
    absorbing the reference's projections gives its weights, every Mamba
    and FFN leaf shared."""
    r = _ref()
    tcfg, jcfg = r["tcfg"], r["jcfg"]
    api, tparams = get_model(tcfg), r["t"]["params"]
    got = api.collect_qkv(tparams, tcfg, make_batch(tcfg, 2, 24, seed=3,
                                                    device="cpu"))
    want = j_get_model(jcfg).collect_qkv(r["params"], jcfg,
                                         j_make_batch(jcfg, 2, 24, seed=3))
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b)
    tpj = calibrate_swan(api, tcfg, tparams,
                         make_batch(tcfg, 2, 24, seed=3, device="cpu"))
    for name in ("p_qk", "p_vo"):
        assert tuple(tpj[name].shape) == (1, 2, 16, 16)
        assert tproj.check_orthogonal(tpj[name]) < 1e-4
        spec = name.replace("p_", "spectrum_")
        np.testing.assert_allclose(tpj[spec].numpy(), np.asarray(r["pj"][spec]),
                                   rtol=1e-3, atol=1e-3)
    tb = make_batch(tcfg, 2, 20, seed=9, device="cpu")
    _close(api.forward(api.absorb(tparams, tcfg, tpj), tcfg, tb),
           api.forward(tparams, tcfg, tb).detach().numpy())
    t_abs = api.absorb(tparams, tcfg, r["t"]["pj"])
    for n in ("wv", "wo"):
        _close(t_abs["groups"]["pos4"]["attn"][n],
               r["absorbed"]["groups"]["pos4"]["attn"][n])
    assert t_abs["groups"]["pos3"] is tparams["groups"]["pos3"]


def _loss_grads(tcfg, jcfg, params, tokens):
    """(port loss, port gradients, reference loss, reference gradients)."""
    japi = j_get_model(jcfg)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, t: japi.loss(
        p, jcfg, {"tokens": t})[0]))(params, jnp.asarray(tokens))
    tp = to_torch(params, device="cpu")
    flat = [x.detach().requires_grad_() for x in leaves(tp)]
    loss, _ = get_model(tcfg).loss(unflatten(tp, flat), tcfg,
                                   {"tokens": torch.as_tensor(tokens)})
    tg = torch.autograd.grad(loss, flat)
    return loss, tg, jl, [np.asarray(b) for b in jax.tree_util.tree_leaves(jg)]


def test_train_step_matches_reference():
    """One training step's loss (the MoE aux included) and every gradient
    (Mamba, attention, experts, router) at S = 16."""
    r = _ref()
    tokens = np.random.default_rng(0).integers(
        0, r["jcfg"].vocab_size, (2, 16)).astype(np.int32)
    loss, tg, jl, jg = _loss_grads(r["tcfg"], r["jcfg"], r["params"], tokens)
    np.testing.assert_allclose(float(loss), float(jl), atol=TOL, rtol=0)
    for (path, _), a, b in zip(flatten_with_path(r["t"]["params"]), tg, jg):
        assert np.max(np.abs(a.numpy() - b)) <= 1e-4 * np.max(np.abs(b)), path


def test_gradients_stay_finite_where_the_reference_overflows():
    """At S = 64 the reference's chunk scan takes exp over the whole
    chunk square and masks afterwards: its backward meets 0·inf and
    leaves non-finite gradients.  The port masks the exponent first: the
    same loss, every gradient finite."""
    r = _ref()
    tokens = np.random.default_rng(1).integers(
        0, r["jcfg"].vocab_size, (2, 64)).astype(np.int32)
    loss, tg, jl, jg = _loss_grads(r["tcfg"], r["jcfg"], r["params"], tokens)
    bad = [p for (p, _), b in zip(flatten_with_path(r["t"]["params"]), jg)
           if not np.isfinite(b).all()]
    assert bad and any("mamba" in p for p in bad)          # the reference's
    assert all(bool(torch.isfinite(a).all()) for a in tg)  # the port's
    np.testing.assert_allclose(float(loss), float(jl), atol=TOL, rtol=0)
    for (path, _), a, b in zip(flatten_with_path(r["t"]["params"]), tg, jg):
        if np.isfinite(b).all():
            assert np.max(np.abs(a.numpy() - b)) <= 1e-4 * np.max(np.abs(b)), \
                path


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _weights(r, swan):
    if not swan:
        return (r["params"], None, None), (r["t"]["params"], None, None)
    return ((r["absorbed"], JSwan(k_max=8, buffer=4), r["pj"]),
            (r["t"]["absorbed"], SwanConfig(k_max=8, buffer=4), r["t"]["pj"]))


@pytest.mark.parametrize("swan", [False, True])
def test_lockstep_logits_and_tokens_match_reference(swan):
    """The lockstep session over the reference's dense attention cache or
    a SWAN one at k = 8 of 16: the prefill logits (37 tokens, a partial
    Mamba chunk), then 13 greedy decode steps' logits and tokens, and
    ``cache_report()``."""
    r = _ref()
    (jw, jsw, jpj), (tw, tsw, tpj) = _weights(r, swan)
    jsess = JSession(r["jcfg"], jw, swan=jsw, projections=jpj, max_seq=64,
                     batch=2)
    tsess = ServeSession(r["tcfg"], tw, swan=tsw, projections=tpj,
                         max_seq=64, batch=2, device="cpu")
    jl = jsess.prefill(j_make_batch(r["jcfg"], 2, 37, seed=2))
    tl = tsess.prefill(make_batch(r["tcfg"], 2, 37, seed=2, device="cpu"))
    for _ in range(13):
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl, -1))
        np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(), tok)
        jl = jsess.decode(jnp.asarray(tok))
        tl = tsess.decode(torch.as_tensor(tok))
    _close(tl, jl)
    assert tsess.pos == jsess.pos == 37 + 13
    assert tsess.cache_report() == jsess.cache_report()


def test_engine_matches_reference():
    """Monolithic admission on the slab with SWAN, 2 slots, seven prompts
    of three lengths (each length is one prefill executable of the
    reference's, since neither engine pads these prompts to buckets):
    tokens, step stamps, engine steps, dispatches, and ``cache_report()``
    (the reference's keys and Eq. 1 bytes, no shard breakdown)."""
    r = _ref()
    (jw, jsw, jpj), (tw, tsw, tpj) = _weights(r, True)
    eng = JEngine(r["jcfg"], jw, swan=jsw, projections=jpj, max_seq=64,
                  n_slots=2)
    comps = eng.run([JRequest(uid=f"r{i}", tokens=p, max_new_tokens=6)
                     for i, p in enumerate(r["prompts"])])
    want = ({c.uid: (c.tokens, c.admitted_step, c.first_token_step,
                     c.finished_step) for c in comps}, eng.step_count,
            eng.cache_report())
    eng = ServeEngine(r["tcfg"], tw, swan=tsw, projections=tpj, max_seq=64,
                      n_slots=2, device="cpu")
    comps = eng.run([Request(uid=f"r{i}", tokens=p, max_new_tokens=6)
                     for i, p in enumerate(r["prompts"])])
    got = {c.uid: (c.tokens, c.admitted_step, c.first_token_step,
                   c.finished_step) for c in comps}
    assert got == want[0]
    assert eng.step_count == want[1]
    assert eng.dispatches == {"prefill": 7, "chunk": 0, "decode": 20}
    assert eng.cache_report() == want[2]
    assert "shards" not in eng.cache_report()


def test_engine_refuses_what_the_family_lacks():
    """As the reference's engine: no paged layout, no chunked prefill, no
    per-request k (the prefill takes no ``k_active``); prompts are not
    padded to buckets (no ``true_len``)."""
    r = _ref()
    _, (tw, tsw, tpj) = _weights(r, True)
    kw = dict(swan=tsw, projections=tpj, max_seq=64, n_slots=2, device="cpu")
    with pytest.raises(ValueError, match="no paged cache"):
        ServeEngine(r["tcfg"], tw, paged=True, page_size=16, **kw)
    with pytest.raises(ValueError, match="chunked prefill unsupported"):
        ServeEngine(r["tcfg"], tw, prefill_chunk=8, **kw)
    eng = ServeEngine(r["tcfg"], tw, **kw)
    assert not eng._bucketing and not eng._k_threading
    with pytest.raises(ValueError, match="per-request k"):
        eng.submit(Request(uid="x", tokens=[1, 2, 3], k=4))


def test_dead_lanes_leave_every_state_leaf_unchanged():
    """A decode step with lane 1 at pos = -1 (the engine's idle lane, and
    every lane of a graph's warm run) changes none of lane 1's state
    leaves, attention cache and Mamba states alike, and advances lane 0
    exactly as a step with every lane live does."""
    r = _ref()
    _, (tw, tsw, tpj) = _weights(r, True)
    api, tcfg = get_model(r["tcfg"]), r["tcfg"]
    batch = make_batch(tcfg, 2, 12, seed=4, device="cpu")
    st = api.init_serve_state(tcfg, tsw, 2, 32, "cpu")
    api.prefill(tw, tcfg, batch, st, tsw, tpj)
    live = {k: v.clone() for k, v in flatten_with_path(st)}
    st_all = unflatten(st, [v.clone() for v in leaves(st)])
    tok = torch.tensor([5, 7])
    la, _ = api.decode_step(tw, tcfg, tok, torch.tensor([12, -1]), st, tsw,
                            tpj)
    lb, _ = api.decode_step(tw, tcfg, tok, 12, st_all, tsw, tpj)
    assert torch.equal(la[0], lb[0])
    changed = []
    for (path, x), (_, y) in zip(flatten_with_path(st),
                                 flatten_with_path(st_all)):
        lane = 1                        # the slot axis follows the [G] axis
        assert torch.equal(x.select(1, lane), live[path].select(1, lane)), \
            path
        assert torch.equal(x.select(1, 0), y.select(1, 0)), path
        if not torch.equal(x, live[path]):
            changed.append(path)
    assert any(p.startswith("mamba") for p in changed)
    assert any(p.startswith("attn") for p in changed)


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

def test_serve_launcher_tokens_match_reference(tmp_path, capsys, monkeypatch):
    """Both launchers on the same float32 checkpoint (the reference's
    weights), each calibrating SWAN itself: the same generated tokens."""
    r = _ref()
    JCheckpointer(str(tmp_path)).save(0, {"params": r["params"]})
    argv = ["--arch", ARCH, "--smoke", "--swan", "--k", "8", "--buffer", "8",
            "--tokens", "6", "--batch", "2", "--prompt-len", "12",
            "--max-seq", "64", "--ckpt-dir", str(tmp_path)]
    monkeypatch.setattr(j_serve_cli, "get_smoke_config",
                        lambda a: j_smoke(a).replace(**F32))
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    j_serve_cli.main()
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("seq ")]
    monkeypatch.setattr(serve_cli, "get_smoke_config",
                        lambda a: get_smoke_config(a).replace(**F32))
    serve_cli.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert [ln for ln in out.splitlines() if ln.startswith("seq ")] == want
    assert len(want) == 2 and "cache [swan[topk]]" in out


def test_engine_and_train_launchers_run_on_cpu(tmp_path, capsys):
    eng = serve_cli.main(["--arch", ARCH, "--smoke", "--swan", "--k", "8",
                          "--buffer", "8", "--tokens", "3", "--batch", "2",
                          "--prompt-len", "12", "--max-seq", "64", "--engine",
                          "--requests", "3", "--device", "cpu"])
    assert "engine: 3 requests, 9 tokens" in capsys.readouterr().out
    assert eng.dispatches["prefill"] == 3
    out = train_cli.main(["--arch", ARCH, "--smoke", "--steps", "3",
                          "--batch", "2", "--seq", "16", "--ckpt-dir",
                          str(tmp_path), "--device", "cpu"])
    assert out["step"] == 3
    assert all(np.isfinite(row["loss"]) for row in out["log"])
