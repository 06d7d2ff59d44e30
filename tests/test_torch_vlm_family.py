"""The ``vlm`` family in the port against the JAX package, on the
internvl2-1b smoke config (7 query heads over 1 kv head: G = 7, q/k/v
biases, 8 patch embeddings ahead of the tokens) at float32, with the
reference's weights and projections carried across.  Its q/k/v biases are
set to seeded non-zero values in the reference's params before anything
runs, so a bias added after RoPE, or a b̂_v lost in absorption, shows.

Checked: the config fields and the init tree, ``make_batch`` bit for bit,
the forward logits over the prefix and the tokens, the loss with the
prefix positions left out, one training step's loss and gradients,
calibration and absorption, prefill and decode logits over dense, SWAN,
int8 and fp8 caches, greedy lockstep tokens, the engine's tokens, steps,
dispatches and cache report (token-only requests, chunked concurrent
prefill on the slab and the paged pool), and both launchers on the CPU.

The reference's ``ServeSession`` continues after a VLM prefill at the
token count (``src/repro/runtime/serve_loop.py:106``), inside the patch
prefix the prefill wrote, so its tokens part from its own model API's
after the first one.  The port continues at the prefill's full length:
its session is held to the reference's model API driven at that position,
and the reference session's departure is shown.  One reference pipeline is
shared by the module."""
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
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro.runtime.serve_engine import Request as JRequest  # noqa: E402
from repro.runtime.serve_engine import ServeEngine as JEngine  # noqa: E402
from repro.runtime.serve_loop import ServeSession as JSession  # noqa: E402
from repro.runtime.serve_loop import calibrate_swan as j_calibrate  # noqa: E402
from repro.runtime.train_loop import make_train_step as j_train_step  # noqa: E402
from repro.optim.adamw import init_opt_state as j_init_opt  # noqa: E402
from repro_torch.configs import (OptimizerConfig, SwanConfig,  # noqa: E402
                                 get_config, get_smoke_config)
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core import projections as tproj  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.io import make_batch  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.optim.adamw import init_opt_state  # noqa: E402
from repro_torch.runtime.serve_engine import Request, ServeEngine  # noqa: E402
from repro_torch.runtime.serve_loop import ServeSession, calibrate_swan  # noqa: E402
from repro_torch.runtime.train_loop import make_train_step  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves, unflatten  # noqa: E402

ARCH = "internvl2-1b"
F32 = dict(dtype="float32", param_dtype="float32")
TOL = 5e-5                              # tests/test_kernels.py:28
# int8 values: a ~1e-7 difference in an f32 vector before quantization can
# land one entry on the other side of a rounding edge (one level of
# round(v / scale) flipped, measured 1 of 512 values after the prefill);
# the decode logits then moved by up to 6.3e-4 on an x86 CPU, so int8 decode
# logits are held to 2e-3 (the prefill reads no packed row: 5e-5)
INT8_TOL = 2e-3
BIAS_STD = 0.1
LENS = [3, 9, 17, 20, 12, 30, 5]        # straddle chunk 8, pages 16, ring 4
LAYOUTS = {"slab": dict(prefill_chunk=8, prefill_slots=2),
           "paged": dict(paged=True, page_size=16, prefill_chunk=8,
                         prefill_slots=2)}
# cache kind -> SwanConfig keywords (None: the dense cache)
CACHES = {"dense": None, "swan": dict(k_max=4, buffer=4),
          "swan_full": dict(k_max=8, buffer=4),
          "int8": dict(k_max=4, buffer=4, quantize=True),
          "fp8": dict(k_max=4, buffer=4, quantize=True, quant_dtype="fp8")}
_REF = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: hundreds of tiny eager ops, which extra threads
    only slow down when the suite's workers share the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _with_biases(params, seed=0):
    """The reference's params with seeded N(0, BIAS_STD) q/k/v biases in
    place of its zeros."""
    attn = params["layers"]["attn"]
    rng = np.random.default_rng(seed)
    new = {n: jnp.asarray(rng.normal(0.0, BIAS_STD, attn[n].shape)
                          .astype(np.float32)) for n in ("bq", "bk", "bv")}
    return {**params, "layers": {**params["layers"],
                                 "attn": {**attn, **new}}}


def _ref():
    """The reference's f32 smoke pipeline (weights with non-zero biases,
    calibration on a batch with patch embeddings, absorption, prompts),
    its tensors in torch, and a cache of its runs."""
    if not _REF:
        jcfg = j_smoke(ARCH).replace(**F32)
        japi = j_get_model(jcfg)
        params = _with_biases(japi.init_params(jax.random.PRNGKey(0), jcfg))
        pj = j_calibrate(japi, jcfg, params, j_make_batch(jcfg, 2, 24, seed=3))
        absorbed = japi.absorb(params, jcfg, pj)
        _REF.update({
            "jcfg": jcfg, "tcfg": get_smoke_config(ARCH).replace(**F32),
            "params": params, "absorbed": absorbed, "pj": pj,
            "t": {n: to_torch(x, device="cpu") for n, x in
                  (("params", params), ("absorbed", absorbed), ("pj", pj))},
            "prompts": [np.asarray(j_make_batch(jcfg, 1, n, seed=40 + i)
                                   ["tokens"][0]).tolist()
                        for i, n in enumerate(LENS)],
            "runs": {}})
    return _REF


# ---------------------------------------------------------------------------
# configs, init, batches
# ---------------------------------------------------------------------------

def test_config_fields_match_reference():
    for mine, theirs in ((get_config(ARCH), j_config(ARCH)),
                         (get_smoke_config(ARCH), j_smoke(ARCH))):
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
        assert mine.q_group == 7
        assert mine.n_params() == theirs.n_params()


def test_init_tree_matches_reference():
    """The port's own init has the reference's leaves, shapes and dtypes
    (bf16), q/k/v biases included and no positional table."""
    cfg, jcfg = get_smoke_config(ARCH), j_smoke(ARCH)
    jp = to_torch(j_get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg),
                  device="cpu")
    tp = get_model(cfg).init_params(cfg, 0, "cpu")
    assert [(p, tuple(x.shape), x.dtype) for p, x in flatten_with_path(tp)] \
        == [(p, tuple(x.shape), x.dtype) for p, x in flatten_with_path(jp)]
    assert "bq" in tp["layers"]["attn"] and "pos_embed" not in tp


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_make_batch_bit_for_bit(dtype):
    """Tokens, then the patch embeddings, from one ``default_rng`` stream,
    rounded to the dtype as the reference rounds them."""
    jb = j_make_batch(j_smoke(ARCH).replace(dtype=dtype), 3, 11, seed=7)
    tb = make_batch(get_smoke_config(ARCH).replace(dtype=dtype), 3, 11,
                    seed=7, device="cpu")
    assert sorted(tb) == sorted(jb) == ["prefix_embeds", "tokens"]
    assert torch.equal(tb["tokens"], torch.as_tensor(np.asarray(jb["tokens"]),
                                                     dtype=torch.int64))
    got = tb["prefix_embeds"]
    assert got.dtype == getattr(torch, dtype) and got.shape == (3, 8, 56)
    assert torch.equal(got, to_torch(jb["prefix_embeds"], device="cpu"))


# ---------------------------------------------------------------------------
# forward, loss, training step, calibration
# ---------------------------------------------------------------------------

def test_forward_and_loss_match_reference():
    """Logits over the patch positions and the tokens, the registry loss
    and ``lm_loss`` under a loss mask: the prefix positions are left out
    of both losses."""
    r = _ref()
    jcfg, tcfg = r["jcfg"], r["tcfg"]
    jb = j_make_batch(jcfg, 2, 20, seed=1)
    tb = make_batch(tcfg, 2, 20, seed=1, device="cpu")
    japi, api = j_get_model(jcfg), get_model(tcfg)
    jl, _ = japi.forward(r["params"], jcfg, jb)
    tl = api.forward(r["t"]["params"], tcfg, tb)
    assert tl.shape == (2, 8 + 20, tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    jloss, jparts = japi.loss(r["params"], jcfg, jb)
    tloss, tparts = api.loss(r["t"]["params"], tcfg, tb)
    for a, b in ((tloss, jloss), (tparts["nll"], jparts["nll"]),
                 (tparts["z"], jparts["z"])):
        np.testing.assert_allclose(float(a), float(b), atol=TOL, rtol=0)
    # the same loss without the prefix's logits is what was computed
    tok_only = tfm.xent_loss(tl[:, 8:], tb["tokens"])[0]
    np.testing.assert_allclose(float(tok_only), float(tloss), atol=1e-6)
    mask = np.random.default_rng(2).integers(0, 2, (2, 20)).astype(np.float32)
    jm = j_tfm.lm_loss(r["params"], jcfg, {**jb, "loss_mask": jnp.asarray(mask)})
    tm = tfm.lm_loss(r["t"]["params"], tcfg,
                     {**tb, "loss_mask": torch.as_tensor(mask)})
    np.testing.assert_allclose(float(tm[0]), float(jm[0]), atol=TOL, rtol=0)


def test_train_step_matches_reference():
    """One optimizer step on a batch with patch embeddings: the loss and
    every gradient (the q/k/v biases included)."""
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
    for (path, _), a, b in zip(flatten_with_path(tp), tg,
                               jax.tree_util.tree_leaves(jg)):
        b = np.asarray(b)
        assert np.max(np.abs(a.numpy() - b)) <= 1e-4 * np.max(np.abs(b)), path
    _, _, tm = make_train_step(tcfg, OptimizerConfig(**opt))(
        tp, init_opt_state(tp, OptimizerConfig(**opt)), tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=TOL, rtol=0)


def test_calibration_and_absorption_match_reference():
    """The port's calibration over a batch with patch embeddings: the
    projections are orthogonal with the reference's spectra; absorbing
    them is lossless; absorbing the reference's gives its weights."""
    r = _ref()
    jcfg, tcfg = r["jcfg"], r["tcfg"]
    api = get_model(tcfg)
    tparams = r["t"]["params"]
    tpj = calibrate_swan(api, tcfg, tparams,
                         make_batch(tcfg, 2, 24, seed=3, device="cpu"))
    for name in ("p_qk", "p_vo"):
        assert tproj.check_orthogonal(tpj[name]) < 1e-4
        spec = name.replace("p_", "spectrum_")
        np.testing.assert_allclose(tpj[spec].numpy(), np.asarray(r["pj"][spec]),
                                   rtol=1e-3, atol=1e-3)
    tb = make_batch(tcfg, 2, 20, seed=9, device="cpu")
    np.testing.assert_allclose(
        api.forward(api.absorb(tparams, tcfg, tpj), tcfg, tb).numpy(),
        api.forward(tparams, tcfg, tb).numpy(), atol=TOL)
    t_abs = api.absorb(tparams, tcfg, r["t"]["pj"])
    for n in ("wv", "wo", "bv"):
        np.testing.assert_allclose(t_abs["layers"]["attn"][n].numpy(),
                                   np.asarray(r["absorbed"]["layers"]["attn"][n]),
                                   atol=TOL)


# ---------------------------------------------------------------------------
# serving: the model API, lockstep, the engine
# ---------------------------------------------------------------------------

def _api_run(api, cfg, weights, swan, proj, batch, steps, greedy_from=None):
    """Prefill ``batch`` (patch embeddings and tokens), then ``steps``
    greedy decode steps at positions P + T, P + T + 1, ... (or at T, T+1,
    ... from ``greedy_from``: the reference session's positions).  Returns
    the logits of each call as numpy [steps + 1, B, V] and the tokens."""
    is_torch = cfg.__class__.__module__.startswith("repro_torch")
    B = batch["tokens"].shape[0]
    kw = {"device": "cpu"} if is_torch else {}
    state = api.init_serve_state(cfg, swan, B, 64, **kw)
    logits, state = api.prefill(weights, cfg, batch, state, swan, proj)
    logits = logits[:, -1]
    pos0 = (batch["tokens"].shape[1] + batch["prefix_embeds"].shape[1]
            if greedy_from is None else greedy_from)
    out, toks = [np.asarray(logits, np.float32)], []
    for i in range(steps):
        tok = (torch.argmax(logits, -1) if is_torch
               else jnp.argmax(logits, -1))
        toks.append(np.asarray(tok))
        logits, state = api.decode_step(weights, cfg, tok, pos0 + i, state,
                                        swan, proj)
        out.append(np.asarray(logits, np.float32))
    return np.stack(out), np.stack(toks, 1)


@pytest.mark.parametrize("cache", list(CACHES))
def test_prefill_and_decode_logits_match_reference(cache):
    """The model API of both packages over one prompt with patch
    embeddings: prefill logits and 4 greedy decode steps at P + T onwards,
    within 5e-5 (int8 decode: ``INT8_TOL``), the cache dense or SWAN (G =
    7 query rows per kv head, the plain twin of the kernel's padded plan on
    the CPU)."""
    r = _ref()
    jcfg, tcfg = r["jcfg"], r["tcfg"]
    sw = CACHES[cache]
    jsw, tsw = (None, None) if sw is None else (JSwan(**sw), SwanConfig(**sw))
    w, tw = ((r["params"], r["t"]["params"]) if sw is None
             else (r["absorbed"], r["t"]["absorbed"]))
    jproj, tproj_ = (None, None) if sw is None else (r["pj"], r["t"]["pj"])
    want, jt = _api_run(j_get_model(jcfg), jcfg, w, jsw, jproj,
                        j_make_batch(jcfg, 2, 12, seed=1), 4)
    got, tt = _api_run(get_model(tcfg), tcfg, tw, tsw, tproj_,
                       make_batch(tcfg, 2, 12, seed=1, device="cpu"), 4)
    np.testing.assert_allclose(got[0], want[0], atol=TOL, rtol=0)
    np.testing.assert_allclose(got[1:], want[1:], rtol=0,
                               atol=INT8_TOL if cache == "int8" else TOL)
    np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("cache", ["dense", "swan"])
def test_lockstep_session_continues_after_the_prefix(cache):
    """The port's session decodes from P + T: its greedy tokens are the
    reference model API's at those positions.  The reference's session
    decodes from T (inside the patch prefix), so its tokens part from the
    same model API's after the first one."""
    r = _ref()
    jcfg, tcfg = r["jcfg"], r["tcfg"]
    sw = CACHES[cache]
    jsw, tsw = (None, None) if sw is None else (JSwan(**sw), SwanConfig(**sw))
    w, tw = ((r["params"], r["t"]["params"]) if sw is None
             else (r["absorbed"], r["t"]["absorbed"]))
    jproj, tproj_ = (None, None) if sw is None else (r["pj"], r["t"]["pj"])
    jb = j_make_batch(jcfg, 2, 12, seed=1)
    n = 8
    _, api_tokens = _api_run(j_get_model(jcfg), jcfg, w, jsw, jproj, jb, n)
    # generate(n + 1) samples the prefill's token and n decodes' tokens
    tsess = ServeSession(tcfg, tw, swan=tsw, projections=tproj_, max_seq=64,
                         batch=2, device="cpu")
    t_out = tsess.generate(make_batch(tcfg, 2, 12, seed=1, device="cpu"),
                           n + 1).numpy()
    np.testing.assert_array_equal(t_out[:, :n], api_tokens)
    assert tsess.pos == 8 + 12 + n
    jsess = JSession(jcfg, w, swan=jsw, projections=jproj, max_seq=64,
                     batch=2)
    j_out = np.asarray(jsess.generate(jb, n + 1))
    np.testing.assert_array_equal(j_out[:, 0], t_out[:, 0])
    assert not np.array_equal(j_out[:, 1:n], t_out[:, 1:n])
    # the reference session is its own model API driven from T
    _, from_t = _api_run(j_get_model(jcfg), jcfg, w, jsw, jproj, jb, n,
                         greedy_from=12)
    np.testing.assert_array_equal(j_out[:, :n], from_t)


def _engine(cls, swan_cls, cfg, weights, layout, **extra):
    k = cfg.d_head // 2
    return cls(cfg, weights["absorbed"], swan=swan_cls(k_max=k, buffer=4),
               projections=weights["pj"], max_seq=64, n_slots=2,
               **LAYOUTS[layout], **extra)


def _requests(cls, cfg, prompts):
    k_cycle = [None, cfg.d_head // 4]
    return [cls(uid=f"r{i}", tokens=p, max_new_tokens=6, k=k_cycle[i % 2])
            for i, p in enumerate(prompts)]


def _summary(eng, comps):
    return ({c.uid: (c.tokens, c.admitted_step, c.first_token_step,
                     c.finished_step) for c in comps},
            eng.step_count, eng.dispatches, eng.cache_report())


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_engine_matches_reference(layout):
    """Token-only requests, as the reference's engine serves a VLM."""
    r = _ref()
    if layout not in r["runs"]:
        eng = _engine(JEngine, JSwan, r["jcfg"], r, layout)
        r["runs"][layout] = _summary(
            eng, eng.run(_requests(JRequest, r["jcfg"], r["prompts"])))
    want = r["runs"][layout]
    eng = _engine(ServeEngine, SwanConfig, r["tcfg"], r["t"], layout,
                  device="cpu")
    got = _summary(eng, eng.run(_requests(Request, r["tcfg"], r["prompts"])))
    assert got[0] == want[0]                  # tokens and step stamps
    assert got[1:3] == want[1:3]              # engine steps, dispatches
    assert got[3] == want[3]                  # cache_report


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", [False, True])
def test_serve_launcher_runs_on_cpu(engine, capsys):
    """The lockstep prompt carries the patch embeddings, so the session
    ends at P + T + new tokens - 1 (the reference's launcher decodes from
    T instead: its tokens differ from the port's by design); the engine
    serves token-only requests."""
    argv = ["--arch", ARCH, "--smoke", "--swan", "--k", "4", "--buffer", "4",
            "--tokens", "3", "--batch", "2", "--prompt-len", "12",
            "--max-seq", "64", "--device", "cpu"]
    if engine:
        argv += ["--engine", "--requests", "3", "--mixed-k", "--paged",
                 "--page-size", "16", "--prefill-chunk", "8",
                 "--prefill-slots", "2"]
    out = serve_cli.main(argv)
    text = capsys.readouterr().out
    if engine:
        assert "engine: 3 requests, 9 tokens" in text
    else:
        assert "cache [swan[topk]]" in text and out.pos == 8 + 12 + 2


def test_train_launcher_runs_on_cpu(tmp_path, capsys):
    out = train_cli.main(["--arch", ARCH, "--smoke", "--steps", "3",
                          "--batch", "2", "--seq", "16", "--ckpt-dir",
                          str(tmp_path), "--device", "cpu"])
    assert out["step"] == 3
    assert all(np.isfinite(r["loss"]) for r in out["log"])
    assert "finished at step 3" in capsys.readouterr().out
