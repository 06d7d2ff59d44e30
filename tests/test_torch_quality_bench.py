"""Port parity for a quality bench end to end: ``bench_adaptive_k`` in
both packages on one tiny LM that the reference trained for a few steps
(the port restores the reference's checkpoint and calibrates on its own):
the same rows, NLLs within 1e-4."""
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import common as tcommon  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run hundreds of tiny eager ops,
    which extra threads only slow down when the suite's workers share the
    cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_common():
    """The reference's ``benchmarks/common.py`` (a package at the repo
    root, next to ``src``)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import benchmarks.common as ref_common
    return ref_common


def _nll_free(derived: str) -> str:
    return re.sub(r"(nll|delta)=[-+0-9.]+", r"\1=", derived)


def test_bench_end_to_end_matches_reference(tmp_path, monkeypatch):
    ref_common = _ref_common()
    import benchmarks.bench_adaptive_k as jbench
    from repro_torch.benchmarks import bench_adaptive_k as tbench
    ckpt = str(tmp_path / "lm")
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path / "out"))
    monkeypatch.setenv("REPRO_BENCH_CKPT", ckpt)
    monkeypatch.setenv("REPRO_BENCH_STEPS", "4")
    monkeypatch.setattr(ref_common, "CKPT_DIR", ckpt)
    monkeypatch.setattr(ref_common, "TRAIN_STEPS", 4)
    nlls = {"j": [], "t": []}
    for tag, mod in (("j", jbench), ("t", tbench)):
        real = mod.swan_teacher_forced_nll
        monkeypatch.setattr(mod, "swan_teacher_forced_nll",
                            lambda *a, _r=real, _t=tag, **k:
                            nlls[_t].append(_r(*a, **k)) or nlls[_t][-1])
    ref_common.trained_tiny_lm.cache_clear()
    tcommon._trained.cache_clear()
    try:
        with ref_common.bench_record("adaptive_k") as jrec:
            jbench._run()
        trec = tbench.run("cpu")
    finally:
        ref_common.trained_tiny_lm.cache_clear()
        tcommon._trained.cache_clear()
    assert (tmp_path / "out" / "BENCH_adaptive_k_torch.json").exists()
    assert [r["name"] for r in trec.rows] == [r["name"] for r in jrec.rows]
    assert [_nll_free(r["derived"]) for r in trec.rows] == \
        [_nll_free(r["derived"]) for r in jrec.rows]
    assert len(nlls["t"]) == len(nlls["j"]) == 4
    np.testing.assert_allclose(nlls["t"], nlls["j"], atol=TOL, rtol=0)


def test_preempted_bench_training_is_refused(tmp_path, monkeypatch):
    """A tiny-LM training cut short by SIGTERM is not calibrated and scored
    as if it were done, and the trainer's SIGTERM handler is removed."""
    import signal
    from repro_torch.runtime.fault_tolerance import PreemptionHandler
    before = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(PreemptionHandler, "triggered",
                        property(lambda self: True))
    with pytest.raises(RuntimeError, match="stopped at step 1 of 3"):
        tcommon._trained.__wrapped__(torch.device("cpu"), str(tmp_path), 3)
    assert signal.getsignal(signal.SIGTERM) is before
