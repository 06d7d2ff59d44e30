"""The port's checkpointer: atomic roundtrip, corruption detection, keep-k
GC, async writes (snapshotted before ``save`` returns), structural
validation, a checkpoint of either package restoring in the other bit for
bit, and exact training resume."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import (OptimizerConfig, TrainConfig,  # noqa: E402
                                 get_smoke_config)
from repro_torch.runtime.train_loop import Trainer  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves  # noqa: E402


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"nested": {"c": torch.randn((2,), generator=g).bfloat16(),
                       "b": torch.arange(7, dtype=torch.int32)},
            "a": torch.randn((4, 3), generator=g),
            "step": torch.tensor(5, dtype=torch.int32)}


def _like(tree):
    return {k: (_like(v) if isinstance(v, dict) else torch.zeros_like(v))
            for k, v in tree.items()}


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_same_bits(a_tree, b_leaves):
    a = leaves(a_tree)
    assert len(a) == len(b_leaves)
    for x, y in zip(a, b_leaves):
        np.testing.assert_array_equal(_bits(x), _bits(y))


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    t = _tree()
    ck.save(3, t)
    out = ck.restore(3, _like(t))
    _assert_same_bits(out, leaves(t))
    for (p, a), (_, b) in zip(flatten_with_path(out), flatten_with_path(t)):
        assert a.dtype == b.dtype and a.shape == b.shape, p


def test_crc_corruption_detected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    ck.save(1, t)
    fn = os.path.join(str(tmp_path), "step_00000001", "arr_00000.bin")
    with open(fn, "r+b") as f:
        b = f.read(1)
        f.seek(0)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(IOError, match="corruption"):
        ck.restore(1, _like(t))


def test_keep_k_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in [1, 2, 3, 4]:
        ck.save(s, _tree())
    assert ck.all_steps() == [3, 4]


def test_async_save_snapshots_before_return(tmp_path):
    """The caller may update its tensors in place as soon as ``save``
    returns: the checkpoint holds the values of the call."""
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    want = [x.clone() for x in leaves(t)]
    ck.save(5, t, blocking=False)
    for x in leaves(t):
        x.add_(1)
    ck.wait()
    assert ck.latest_step() == 5
    _assert_same_bits(ck.restore(5, _like(t)), want)


def test_shape_mismatch_rejected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.zeros((3,))})
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(1, {"a": torch.zeros((4,))})
    with pytest.raises(ValueError, match="leaf count mismatch"):
        ck.restore(1, {"a": torch.zeros((3,)), "b": torch.zeros((3,))})


def test_restore_matches_leaves_by_path(tmp_path):
    """Leaves are found by their paths, never by position: same-shaped
    leaves land under their own names, and a target path the checkpoint
    lacks is refused even when the leaf counts agree."""
    ck = Checkpointer(str(tmp_path))
    wk, wv = torch.full((2, 3), 1.0), torch.full((2, 3), 2.0)
    ck.save(1, {"wk": wk, "wv": wv})
    out = ck.restore(1, {"wv": torch.zeros(2, 3), "wk": torch.zeros(2, 3)})
    assert torch.equal(out["wk"], wk) and torch.equal(out["wv"], wv)
    with pytest.raises(ValueError, match="leaf count mismatch"):
        ck.restore(1, {"wk": torch.zeros(2, 3), "wq": torch.zeros(2, 3)})


def test_tmp_litter_cleaned(tmp_path):
    ck = Checkpointer(str(tmp_path))
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    ck.save(1, _tree())
    assert not any(d.endswith(".tmp") for d in os.listdir(str(tmp_path)))


def test_reference_save_restores_in_port(tmp_path):
    k = jax.random.PRNGKey(0)
    jt = {"params": {"w": jax.random.normal(k, (4, 3)),
                     "e": jax.random.normal(k, (5,), jnp.bfloat16)},
          "opt": {"step": jnp.asarray(7, jnp.int32),
                  "m": {"w": jnp.ones((4, 3))}}}
    JCheckpointer(str(tmp_path)).save(2, jt)
    like = {"opt": {"m": {"w": torch.zeros(4, 3)},
                    "step": torch.zeros((), dtype=torch.int32)},
            "params": {"e": torch.zeros(5, dtype=torch.bfloat16),
                       "w": torch.zeros(4, 3)}}
    out = Checkpointer(str(tmp_path)).restore(2, like)
    _assert_same_bits(out, jax.tree_util.tree_leaves(jt))
    assert out["params"]["e"].dtype == torch.bfloat16
    assert int(out["opt"]["step"]) == 7


def test_port_save_restores_in_reference(tmp_path):
    t = _tree(1)
    Checkpointer(str(tmp_path)).save(4, t)
    like = jax.tree_util.tree_map(
        lambda x: np.zeros(x.shape, jnp.bfloat16 if x.dtype == torch.bfloat16
                           else x.numpy().dtype), t)
    out = JCheckpointer(str(tmp_path)).restore(4, like)
    _assert_same_bits(t, jax.tree_util.tree_leaves(out))
    assert str(out["nested"]["c"].dtype) == "bfloat16"


def test_params_restore_from_trainer_checkpoint(tmp_path):
    """``{"params": ...}`` restores the params of a ``{"params", "opt"}``
    checkpoint, by path (the serve launcher's ``--ckpt-dir``)."""
    t = {"params": _tree(2), "opt": {"m": _tree(3)}}
    Checkpointer(str(tmp_path)).save(1, t)
    out = Checkpointer(str(tmp_path)).restore(1, {"params": _like(t["params"])})
    _assert_same_bits(out, leaves(t["params"]))


def test_training_resume_bit_exact(tmp_path):
    """6 steps straight vs 3 + checkpoint + fresh Trainer + 3 more: the
    same losses and final params, bit for bit (data is a pure function of
    the step; state round-trips losslessly)."""
    cfg = get_smoke_config("llama3-8b").replace(remat=False)
    base = dict(model=cfg, seq_len=16, global_batch=4,
                optimizer=OptimizerConfig(lr=1e-2, warmup_steps=2,
                                          decay_steps=6),
                log_every=1, keep_checkpoints=5, async_checkpoint=True)
    tc1 = TrainConfig(steps=6, checkpoint_dir=str(tmp_path / "a"),
                      checkpoint_every=100, **base)
    out1 = Trainer(tc1, device="cpu").run()
    tc2 = TrainConfig(steps=6, checkpoint_dir=str(tmp_path / "b"),
                      checkpoint_every=3, **base)
    Trainer(tc2, device="cpu").run(steps=3)
    t2 = Trainer(tc2, device="cpu")
    out2 = t2.run()                                   # resumes at 3
    assert out2["step"] == 6
    assert [r["loss"] for r in out2["log"]] == \
        [r["loss"] for r in out1["log"][3:]]
    _assert_same_bits(out2["params"], leaves(out1["params"]))
    _assert_same_bits(out2["opt"], leaves(out1["opt"]))
