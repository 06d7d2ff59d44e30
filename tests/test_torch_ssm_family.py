"""The ``ssm`` family (RWKV-6, attention-free) in the port against the JAX
package, on the rwkv6-3b smoke config at float32, with the reference's
weights carried across.

Checked: the config fields and both parameter counts (the reference's
formula and its leaves), the init tree, the chunked wkv against the
reference's and against the sequential recurrence, the channel mix's
decode against its forward, ``lm_forward`` logits, prefill and decode
logits and tokens through the lockstep session, prefill then decode
against the forward at the same positions, the engine's tokens, steps,
dispatches and cache report (0 bytes: no KV cache), one training step's
loss and gradients, a dead lane leaving the state unchanged, SWAN refused
(``swan_applicable`` false, as the reference's for every arch), and both
launchers: the serve launcher's tokens against the reference's launcher on
the same checkpoint, and ``--swan`` exiting non-zero with
"inapplicable".  One reference pipeline is shared by the module."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import serve as j_serve_cli  # noqa: E402
from repro.launch.io import make_batch as j_make_batch  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import rwkv as j_rwkv  # noqa: E402
from repro.models.registry import swan_applicable as j_swan_applicable  # noqa: E402
from repro.runtime.serve_engine import Request as JRequest  # noqa: E402
from repro.runtime.serve_engine import ServeEngine as JEngine  # noqa: E402
from repro.runtime.serve_loop import ServeSession as JSession  # noqa: E402
from repro_torch.configs import (ARCH_IDS, SwanConfig,  # noqa: E402
                                 get_config, get_smoke_config)
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.io import make_batch  # noqa: E402
from repro_torch.models import rwkv  # noqa: E402
from repro_torch.models.registry import get_model, swan_applicable  # noqa: E402
from repro_torch.runtime.serve_engine import Request, ServeEngine  # noqa: E402
from repro_torch.runtime.serve_loop import ServeSession  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves, unflatten  # noqa: E402

ARCH = "rwkv6-3b"
F32 = dict(dtype="float32", param_dtype="float32")
TOL = 5e-5                              # tests/test_kernels.py:28
LENS = [9, 30, 9, 20, 30, 9, 20]        # three prompt lengths
SRC = Path(__file__).resolve().parents[1] / "src"
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
    """The reference's f32 smoke weights and prompts, and the weights in
    torch."""
    if not _REF:
        jcfg = j_smoke(ARCH).replace(**F32)
        params = j_get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
        _REF.update({
            "jcfg": jcfg, "tcfg": get_smoke_config(ARCH).replace(**F32),
            "params": params, "t": to_torch(params, device="cpu"),
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
    for mine, theirs in ((get_config(ARCH), j_config(ARCH)),
                         (get_smoke_config(ARCH), j_smoke(ARCH))):
        for f in dataclasses.fields(mine):
            if f.name != "rwkv":
                assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
        assert mine.rwkv.head_dim == theirs.rwkv.head_dim
        assert mine.is_attention_free and theirs.is_attention_free
        assert {mine.layer_kind(i) for i in range(mine.n_layers)} == {"rwkv"}


def test_param_counts_formula_and_leaves():
    """The reference's formula gives 2.863 B for the full config; the
    leaves hold 3.074 B: the formula leaves out each layer's channel-mix
    receptance ``w_r`` (d²), counts 4·d of its 15·d in norm, shift-mix,
    decay, bonus and group-norm vectors, and leaves out the final norm
    (2·d)."""
    cfg = get_config(ARCH)
    assert cfg.n_params() == j_config(ARCH).n_params() == 2_862_940_160
    assert cfg.n_active_params() == cfg.n_params()
    shapes = jax.eval_shape(lambda: j_get_model(j_config(ARCH)).init_params(
        jax.random.PRNGKey(0), j_config(ARCH)))
    n_leaves = sum(int(np.prod(x.shape))
                   for x in jax.tree_util.tree_leaves(shapes))
    d, L = cfg.d_model, cfg.n_layers
    assert n_leaves == cfg.n_params() + L * (d * d + 11 * d) + 2 * d \
        == 3_073_561_600


def test_init_tree_matches_reference():
    cfg, jcfg = get_smoke_config(ARCH), j_smoke(ARCH)     # bf16 params
    jp = jax.eval_shape(lambda: j_get_model(jcfg).init_params(
        jax.random.PRNGKey(0), jcfg))
    tp = get_model(cfg).init_params(cfg, 0, "cpu")
    assert [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in flatten_with_path(tp)] == \
        [(p, tuple(x.shape), str(x.dtype)) for p, x in flatten_with_path(jp)]
    tm = tp["layers"]["tm"]
    d = cfg.d_model
    want = torch.tensor([-6.0 + 5.0 * (i / (d - 1)) ** 0.9 for i in range(d)])
    assert torch.equal(tm["decay_w"][1], want)
    assert float(tm["decay_w"][0, -1]) == -1.0


def test_swan_applicability_matches_reference():
    """``swan_applicable`` is the reference's for every arch of the port:
    false for rwkv6-3b only (no calibration capture), and its serve state
    refuses SWAN."""
    for arch in ARCH_IDS:
        assert arch in J_ARCH_IDS
        assert swan_applicable(get_config(arch)) == \
            j_swan_applicable(j_config(arch)), arch
    cfg = get_smoke_config(ARCH)
    assert not swan_applicable(cfg) and get_model(cfg).collect_qkv is None
    with pytest.raises(ValueError, match="inapplicable"):
        get_model(cfg).init_serve_state(cfg, SwanConfig(k_max=8), 1, 16, "cpu")


# ---------------------------------------------------------------------------
# the time and channel mixes alone
# ---------------------------------------------------------------------------

def test_chunk_wkv_matches_reference_and_the_recurrence():
    """The time mix over 150 tokens (chunks of 64, a short last one):
    the port's chunked wkv against the reference's, its decode recurrence
    against the reference's, and chunked against sequential at the
    reference's own test's tolerance (tests/test_mamba_rwkv.py:54);
    the final state the prefill keeps against the recurrence's.  The bonus
    ``u`` is set non-zero so that its term shows."""
    jcfg = j_smoke(ARCH).replace(**F32)
    tcfg = get_smoke_config(ARCH).replace(**F32)
    p = j_rwkv.init_time_mix_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    p = {**p, "bonus_u": jnp.asarray(rng.normal(0, 0.5, p["bonus_u"].shape)
                                     .astype(np.float32))}
    x = (rng.standard_normal((2, 150, jcfg.d_model)) * 0.5).astype(np.float32)
    jy, jS = j_rwkv.time_mix_forward(p, jcfg, jnp.asarray(x),
                                     return_state=True)
    tp = to_torch(p, device="cpu")
    with torch.no_grad():
        ty, tS = rwkv.time_mix_forward(tp, tcfg, torch.as_tensor(x),
                                       return_state=True)
        st = rwkv.init_rwkv_state(tcfg, 2, "cpu")
        seq = torch.cat([rwkv.time_mix_decode(tp, tcfg,
                                              torch.as_tensor(x[:, t:t + 1]),
                                              st) for t in range(150)], 1)
    _close(ty, jy)
    _close(tS, jS)
    jst = {"S": jnp.zeros((2, 4, 16, 16)), "x_tm": jnp.zeros((2, 1, 64)),
           "x_cm": jnp.zeros((2, 1, 64))}
    jseq = []
    for t in range(12):
        y, jst = j_rwkv.time_mix_decode(p, jcfg, jnp.asarray(x[:, t:t + 1]),
                                        jst)
        jseq.append(y)
    _close(seq[:, :12], jnp.concatenate(jseq, 1))
    np.testing.assert_allclose(ty.numpy(), seq.numpy(), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(tS.numpy(), st["S"].numpy(), atol=2e-4,
                               rtol=1e-3)


def test_chunk_wkv_gradients_are_finite():
    """The masked exponent keeps the backward finite over a whole chunk of
    strong decays (where exp(cum_prev_t - cum_τ), τ >= t, would be huge)."""
    B, Q, H, dk = 1, 64, 2, 8
    rng = np.random.default_rng(3)
    r, k, v = (torch.as_tensor(rng.standard_normal((B, Q, H, dk))
                               .astype(np.float32)).requires_grad_()
               for _ in range(3))
    logw = torch.full((B, Q, H, dk), -3.0, requires_grad=True)
    y, h = rwkv._chunk_wkv(r, k, v, logw, torch.zeros(H, dk),
                           torch.zeros(B, H, dk, dk))
    grads = torch.autograd.grad((y.sum() + h.sum()), (r, k, v, logw))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_channel_mix_decode_matches_forward_and_reference():
    jcfg = j_smoke(ARCH).replace(**F32)
    tcfg = get_smoke_config(ARCH).replace(**F32)
    p = j_rwkv.init_channel_mix_params(jax.random.PRNGKey(4), jcfg)
    x = np.random.default_rng(5).standard_normal(
        (2, 9, jcfg.d_model)).astype(np.float32)
    tp = to_torch(p, device="cpu")
    with torch.no_grad():
        fwd = rwkv.channel_mix_forward(tp, tcfg, torch.as_tensor(x))
        st = rwkv.init_rwkv_state(tcfg, 2, "cpu")
        dec = torch.cat([rwkv.channel_mix_decode(
            tp, tcfg, torch.as_tensor(x[:, t:t + 1]), st) for t in range(9)],
            1)
    _close(fwd, j_rwkv.channel_mix_forward(p, jcfg, jnp.asarray(x)))
    np.testing.assert_allclose(dec.numpy(), fwd.numpy(), atol=1e-5)
    assert torch.equal(st["x_cm"][:, 0], torch.as_tensor(x[:, -1]))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_lm_forward_logits():
    r = _ref()
    jb = j_make_batch(r["jcfg"], 2, 80, seed=1)
    jl, jaux = j_get_model(r["jcfg"]).forward(r["params"], r["jcfg"], jb)
    tl, taux = get_model(r["tcfg"]).forward_aux(
        r["t"], r["tcfg"], make_batch(r["tcfg"], 2, 80, seed=1, device="cpu"))
    _close(tl, jl)
    assert float(taux) == float(jaux) == 0.0


def test_prefill_then_decode_equals_the_forward():
    """Prefill of 70 tokens, then decode of the next 10 given ones: each
    step's logits equal the forward's at its position (the reference's
    tests/test_mamba_rwkv.py:71, in the port)."""
    r = _ref()
    api, tcfg = get_model(r["tcfg"]), r["tcfg"]
    toks = make_batch(tcfg, 2, 80, seed=6, device="cpu")["tokens"]
    with torch.no_grad():
        full = api.forward(r["t"], tcfg, {"tokens": toks})
    st = api.init_serve_state(tcfg, None, 2, 128, "cpu")
    lg, _ = api.prefill(r["t"], tcfg, {"tokens": toks[:, :70]}, st)
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, 69].numpy(),
                               atol=2e-4, rtol=1e-3)
    for t in range(70, 80):
        lg, _ = api.decode_step(r["t"], tcfg, toks[:, t], t, st)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   atol=2e-4, rtol=1e-3)


def test_train_step_matches_reference():
    r = _ref()
    jcfg, tcfg = r["jcfg"], r["tcfg"]
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    japi = j_get_model(jcfg)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, t: japi.loss(
        p, jcfg, {"tokens": t})[0]))(r["params"], jnp.asarray(tokens))
    tp = to_torch(r["params"], device="cpu")
    flat = [x.detach().requires_grad_() for x in leaves(tp)]
    loss, _ = get_model(tcfg).loss(unflatten(tp, flat), tcfg,
                                   {"tokens": torch.as_tensor(tokens)})
    tg = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=TOL,
                               rtol=0)
    for (path, _), a, b in zip(flatten_with_path(tp), tg,
                               jax.tree_util.tree_leaves(jg)):
        b = np.asarray(b)
        assert np.max(np.abs(a.numpy() - b)) <= 1e-4 * np.max(np.abs(b)), path


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_lockstep_logits_and_tokens_match_reference():
    """Prefill (100 tokens: two chunks) and 13 greedy decode steps through
    both sessions: logits, tokens and the cache report (0 bytes)."""
    r = _ref()
    jsess = JSession(r["jcfg"], r["params"], max_seq=128, batch=2)
    tsess = ServeSession(r["tcfg"], r["t"], max_seq=128, batch=2,
                         device="cpu")
    jl = jsess.prefill(j_make_batch(r["jcfg"], 2, 100, seed=2))
    tl = tsess.prefill(make_batch(r["tcfg"], 2, 100, seed=2, device="cpu"))
    for _ in range(13):
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl, -1))
        np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(), tok)
        jl = jsess.decode(jnp.asarray(tok))
        tl = tsess.decode(torch.as_tensor(tok))
    _close(tl, jl)
    assert tsess.cache_report() == jsess.cache_report() == \
        {"mode": "dense", "bytes": 0}


def test_engine_matches_reference():
    """Monolithic admission on the slab, 2 slots, seven prompts of three
    lengths: tokens, step stamps, engine steps, dispatches and the cache
    report (Eq. 1 counts attention layers only: 0 bytes)."""
    r = _ref()
    eng = JEngine(r["jcfg"], r["params"], max_seq=64, n_slots=2)
    comps = eng.run([JRequest(uid=f"r{i}", tokens=p, max_new_tokens=6)
                     for i, p in enumerate(r["prompts"])])
    want = {c.uid: (c.tokens, c.admitted_step, c.first_token_step,
                    c.finished_step) for c in comps}
    teng = ServeEngine(r["tcfg"], r["t"], max_seq=64, n_slots=2, device="cpu")
    got = teng.run([Request(uid=f"r{i}", tokens=p, max_new_tokens=6)
                    for i, p in enumerate(r["prompts"])])
    assert {c.uid: (c.tokens, c.admitted_step, c.first_token_step,
                    c.finished_step) for c in got} == want
    assert teng.step_count == eng.step_count
    assert teng.dispatches == {"prefill": 7, "chunk": 0, "decode": 20}
    assert teng.cache_report() == eng.cache_report()
    assert teng.cache_report()["bytes"] == 0


def test_dead_lanes_leave_the_state_unchanged():
    r = _ref()
    api, tcfg = get_model(r["tcfg"]), r["tcfg"]
    st = api.init_serve_state(tcfg, None, 2, 32, "cpu")
    api.prefill(r["t"], tcfg, make_batch(tcfg, 2, 12, seed=4, device="cpu"),
                st)
    before = {p: x.clone() for p, x in flatten_with_path(st)}
    st_all = unflatten(st, [x.clone() for x in leaves(st)])
    tok = torch.tensor([5, 7])
    la, _ = api.decode_step(r["t"], tcfg, tok, torch.tensor([12, -1]), st)
    lb, _ = api.decode_step(r["t"], tcfg, tok, 12, st_all)
    assert torch.equal(la[0], lb[0])
    for (path, x), (_, y) in zip(flatten_with_path(st),
                                 flatten_with_path(st_all)):
        assert torch.equal(x[:, 1], before[path][:, 1]), path
        assert torch.equal(x[:, 0], y[:, 0]), path
        assert not torch.equal(x[:, 0], before[path][:, 0]), path


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

def test_serve_launcher_tokens_match_reference(tmp_path, capsys, monkeypatch):
    """Both launchers on the same float32 checkpoint (the reference's
    weights): the same generated tokens."""
    r = _ref()
    JCheckpointer(str(tmp_path)).save(0, {"params": r["params"]})
    argv = ["--arch", ARCH, "--smoke", "--tokens", "6", "--batch", "2",
            "--prompt-len", "12", "--max-seq", "64", "--ckpt-dir",
            str(tmp_path)]
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
    assert len(want) == 2 and "cache [dense]: 0.00 MB" in out


def test_serve_launcher_refuses_swan():
    """As the reference's launcher (tests/test_launch_cli.py:35-40): a
    non-zero exit that says "inapplicable"."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--swan", "--tokens", "2", "--max-seq", "32",
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=120)
    assert out.returncode != 0
    assert "inapplicable" in out.stdout + out.stderr


def test_engine_and_train_launchers_run_on_cpu(tmp_path, capsys):
    eng = serve_cli.main(["--arch", ARCH, "--smoke", "--tokens", "3",
                          "--batch", "2", "--prompt-len", "12", "--max-seq",
                          "64", "--engine", "--requests", "3", "--device",
                          "cpu"])
    assert "engine: 3 requests, 9 tokens" in capsys.readouterr().out
    assert eng.dispatches["prefill"] == 3
    out = train_cli.main(["--arch", ARCH, "--smoke", "--steps", "3",
                          "--batch", "2", "--seq", "16", "--ckpt-dir",
                          str(tmp_path), "--device", "cpu"])
    assert out["step"] == 3
    assert all(np.isfinite(row["loss"]) for row in out["log"])
