"""The port's benchmark harness (``repro_torch.benchmarks.run``) against
the reference's (``benchmarks/run.py``): the same modules in the same
order, ``aggregate()`` folding the port's artifacts alone into
``BENCH_SUMMARY_torch.json`` with the reference's summary of them, and
``main()``'s header and exit code."""
import json
import os
import shutil
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.benchmarks import run as trun  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _ref_run():
    """The reference harness (a package at the repo root)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import importlib
    return importlib.import_module("benchmarks.run")


def test_modules_and_order_match_reference():
    jrun = _ref_run()
    assert [n for n, _ in trun.MODULES] == [n for n, _ in jrun.MODULES]
    for (name, tmod), (_, jmod) in zip(trun.MODULES, jrun.MODULES):
        assert tmod.__name__ == "repro_torch." + jmod.__name__, name
        assert callable(tmod.run)


def _artifact(outdir, bench, ok, gates, rows=2, **extra):
    with open(os.path.join(outdir, f"BENCH_{bench}.json"), "w") as fh:
        json.dump({"bench": bench, "ok": ok, "rows": [{}] * rows,
                   "gates": [{"name": g, "passed": p, "detail": ""}
                             for g, p in gates.items()], **extra}, fh)


def test_aggregate_folds_the_ports_artifacts_alone(tmp_path, monkeypatch):
    """Both packages' artifacts in one directory: the port's summary is
    the reference harness's summary of the port's artifacts alone, in
    ``BENCH_SUMMARY_torch.json``; the reference's summary file is neither
    read nor written."""
    both, ports = tmp_path / "both", tmp_path / "ports"
    both.mkdir()
    ports.mkdir()
    # real artifacts of the analytical benches, from each package
    monkeypatch.setenv("REPRO_BENCH_OUT", str(both))
    jrun = _ref_run()
    import importlib
    for name in ("fig2a_compression", "breakeven", "memory_footprint"):
        importlib.import_module(f"repro_torch.benchmarks.bench_{name}").run()
        importlib.import_module(f"benchmarks.bench_{name}").run()
    # a failing port bench, a reference one, a stale reference summary
    _artifact(both, "kernels_torch", False, {"finite": True, "floor": False},
              torch_version="x", device="cpu")
    _artifact(both, "kernels", True, {"finite": True}, jax_version="y")
    (both / "BENCH_SUMMARY.json").write_text('{"stale": true}\n')
    port_files = sorted(p.name for p in both.glob("BENCH_*_torch.json"))
    assert len(port_files) == 4
    for name in port_files:
        shutil.copy(both / name, ports / name)

    got = trun.aggregate()
    monkeypatch.setenv("REPRO_BENCH_OUT", str(ports))
    want = jrun.aggregate()
    assert got == want
    assert got["n_benches"] == 4 and not got["all_ok"]
    assert got["gates_failed"] == ["kernels_torch:floor"]
    assert (both / "BENCH_SUMMARY.json").read_text() == '{"stale": true}\n'
    with open(both / "BENCH_SUMMARY_torch.json") as fh:
        assert json.load(fh) == got
    # a second fold ignores the summary it wrote
    monkeypatch.setenv("REPRO_BENCH_OUT", str(both))
    assert trun.aggregate() == got


class _Stub:
    def __init__(self, fail=False, takes=()):
        self.fail, self.calls = fail, []
        if "device" in takes:
            def run(smoke=False, device=None):
                self.calls.append((smoke, device))
                if self.fail:
                    raise RuntimeError("stub failure")
        else:
            def run():
                self.calls.append(())
        self.run = run


def test_main_prints_the_header_and_fails_on_a_failed_module(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path))
    good, bad = _Stub(), _Stub(fail=True, takes=("device",))
    monkeypatch.setattr(trun, "MODULES", [("good", good), ("bad", bad)])
    with pytest.raises(SystemExit) as exc:
        trun.main(["--smoke", "--device", "cpu"])
    assert exc.value.code == 1
    out, err = capsys.readouterr()
    assert out.splitlines()[0] == "name,us_per_call,derived"
    assert "# [good] ok in" in err and "# [bad] FAILED" in err
    assert good.calls == [()] and bad.calls == [(True, "cpu")]
    # every module passing: no exit
    monkeypatch.setattr(trun, "MODULES", [("good", good)])
    trun.main(["--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == ["name,us_per_call,derived"]
