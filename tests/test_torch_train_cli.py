"""The port's training launcher and the serve launcher's ``--ckpt-dir`` on
the CPU, the training launcher's TrainConfig against the reference
launcher's for every arch, and a subprocess check that training and a
quality bench load nothing of JAX or of the reference package."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.launch import train as ref_train_launcher  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


def test_train_then_serve_from_checkpoint(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    out = train_launcher.main(["--arch", "llama3-8b", "--smoke", "--steps",
                               "4", "--batch", "4", "--seq", "16",
                               "--ckpt-dir", ck, "--ckpt-every", "2",
                               "--grad-accum", "2", "--device", "cpu"])
    assert out["step"] == 4 and len(out["log"]) == 4
    assert sorted(os.listdir(ck)) == ["step_00000002", "step_00000004"]
    sess = serve_launcher.main(["--arch", "llama3-8b", "--smoke",
                                "--ckpt-dir", ck, "--swan", "--k", "8",
                                "--buffer", "8", "--tokens", "3", "--batch",
                                "2", "--prompt-len", "12", "--max-seq", "64",
                                "--device", "cpu"])
    text = capsys.readouterr().out
    assert "finished at step 4" in text
    assert "restored checkpoint step 4" in text
    trained = out["params"]["layers"]["attn"]["wq"]
    # the session serves the restored weights (wq is not absorbed)
    assert torch.equal(sess.params["layers"]["attn"]["wq"], trained)


def test_train_and_quality_bench_import_no_jax(tmp_path):
    code = (
        "import sys\n"
        "import repro_torch.launch.train as t\n"
        f"t.main(['--arch', 'llama3-8b', '--smoke', '--steps', '2', "
        f"'--batch', '2', '--seq', '8', '--ckpt-dir', "
        f"{str(tmp_path / 'ck')!r}, '--grad-compression', 'int8', "
        "'--device', 'cpu'])\n"
        "from repro_torch.benchmarks import (bench_table1_retention, "
        "bench_table2_kv_split, bench_table3_projection, "
        "bench_buffer_rescue, bench_longcontext_error)\n"
        "from repro_torch.benchmarks import bench_adaptive_k\n"
        "rec = bench_adaptive_k.run('cpu')\n"
        "assert len(rec.rows) == 4, rec.rows\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.split('.')[0] in ('repro', 'benchmarks')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # one intra-op thread: the scoring's tiny eager ops gain nothing from
    # more, and the suite's workers share the cores
    env.update(PYTHONPATH=str(SRC), REPRO_BENCH_OUT=str(tmp_path / "out"),
               REPRO_BENCH_CKPT=str(tmp_path / "lm"), REPRO_BENCH_STEPS="2",
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "clean"
    assert (tmp_path / "out" / "BENCH_adaptive_k_torch.json").exists()


class _Built(Exception):
    """Raised by the stub trainer once the launcher has built its
    TrainConfig."""

    def __init__(self, tc):
        super().__init__("built")
        self.tc = tc


def _stub_trainer(tc, *args, **kwargs):
    raise _Built(tc)


def _train_config(module, argv, monkeypatch):
    """The TrainConfig ``module``'s launcher builds for ``argv`` (its
    trainer is stubbed: nothing trains)."""
    monkeypatch.setattr(module, "Trainer", _stub_trainer)
    try:
        if module is ref_train_launcher:
            monkeypatch.setattr(sys, "argv", ["train"] + argv)
            module.main()
        else:
            module.main(argv)
    except _Built as built:
        return built.tc
    raise AssertionError("the launcher built no trainer")


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_launchers_agree_on_the_moments_dtype(arch, smoke, monkeypatch):
    """Both training launchers give the optimizer the config's
    ``opt_state_dtype`` (bfloat16 for the full jamba-1.5-large-398b and
    for llama3-405b, whose smoke config keeps it too); the port refuses the
    encoder-decoder, whose stream has no frames."""
    argv = ["--arch", arch, "--steps", "5", "--lr", "1e-3"] + (
        ["--smoke"] if smoke else [])
    want = _train_config(ref_train_launcher, argv, monkeypatch)
    if want.model.is_encoder_decoder:
        with pytest.raises(SystemExit, match="encoder frames"):
            train_launcher.main(argv + ["--device", "cpu"])
        return
    got = _train_config(train_launcher, argv + ["--device", "cpu"],
                        monkeypatch)
    assert got.optimizer.state_dtype == want.optimizer.state_dtype \
        == want.model.opt_state_dtype == got.model.opt_state_dtype
    assert (got.optimizer.lr, got.optimizer.decay_steps) == \
        (want.optimizer.lr, want.optimizer.decay_steps)
    if arch == "llama3-405b" or (arch == "jamba-1.5-large-398b"
                                 and not smoke):
        assert got.optimizer.state_dtype == "bfloat16"
