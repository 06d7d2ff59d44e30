"""The sharded engine's entry points on the CPU: the serve launcher's
``--data-parallel`` / ``--mesh-shape`` against the reference's launcher,
the batched example's ``--data-parallel``, and the ported
``bench_sharded_serve`` at dp = 8 (its gates, its artifact folded by the
harness); and the sharded paths without jax."""
import importlib.util
import json
import sys
from pathlib import Path

import jax
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import serve as j_serve_cli  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro_torch.benchmarks import bench_sharded_serve  # noqa: E402
from repro_torch.benchmarks import run as bench_run  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
BASE = ["--arch", "llama3-8b", "--smoke", "--swan", "--k", "8", "--buffer",
        "8", "--tokens", "5", "--batch", "4", "--prompt-len", "12",
        "--max-seq", "64", "--engine", "--requests", "4", "--mixed-k"]
LAYOUTS = {"slab": [],
           "paged": ["--paged", "--page-size", "16", "--prefill-chunk", "8",
                     "--prefill-slots", "2"]}


def _tokens(out):
    """The launcher's printed requests: {uid: token list}."""
    return {ln.split(" ", 1)[0]: ln.split(":", 1)[-1]
            for ln in out.splitlines() if ln.startswith("req")}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """One reference checkpoint of the float32 smoke config, and the
    reference launcher's printed tokens per layout (run once each)."""
    path = tmp_path_factory.mktemp("ckpt")
    jcfg = j_smoke("llama3-8b").replace(**F32)
    params = j_get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    JCheckpointer(str(path)).save(0, {"params": params})
    return {"path": str(path), "want": {}}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mesh_flag", [["--data-parallel", "2"],
                                       ["--mesh-shape", "data=2,model=2"]])
def test_launcher_matches_the_reference_single_device(
        layout, mesh_flag, ckpt, capsys, monkeypatch):
    """The port's launcher over a two-shard mesh on the CPU prints the
    reference's single-device launcher's tokens, on one reference
    checkpoint (each calibrates SWAN itself)."""
    argv = BASE + LAYOUTS[layout] + ["--ckpt-dir", ckpt["path"]]
    if layout not in ckpt["want"]:
        monkeypatch.setattr(j_serve_cli, "get_smoke_config",
                            lambda a: j_smoke(a).replace(**F32))
        monkeypatch.setattr(sys, "argv", ["serve"] + argv)
        capsys.readouterr()
        j_serve_cli.main()
        ckpt["want"][layout] = _tokens(capsys.readouterr().out)
    want = ckpt["want"][layout]
    capsys.readouterr()
    monkeypatch.setattr(serve_cli, "get_smoke_config",
                        lambda a: get_smoke_config(a).replace(**F32))
    eng = serve_cli.main(argv + mesh_flag + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert eng.dp == 2 and eng.n_local == 2
    assert "— 2 shards x 2 slots" in out
    got = _tokens(out)
    assert len(want) == 2 and got == want


def test_data_parallel_requires_the_engine(monkeypatch):
    """Without --engine both launchers exit with the reference's message."""
    argv = ["--arch", "llama3-8b", "--smoke", "--data-parallel", "2"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(SystemExit) as want:
        j_serve_cli.main()
    with pytest.raises(SystemExit) as got:
        serve_cli.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value) != ""


def test_launcher_refuses_more_shards_than_cards(monkeypatch):
    """On the card the mesh takes N visible cards: fewer refuse N."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    args = serve_cli.argparse.Namespace(mesh_shape=None, data_parallel=2)
    with pytest.raises(SystemExit, match="2 visible CUDA devices, 1"):
        serve_cli._serve_mesh(args, torch.device("cuda"))


def _load_example():
    spec = importlib.util.spec_from_file_location(
        "_torch_serve_batched", EXAMPLES / "torch_serve_batched.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_data_parallel_runs_on_cpu(capsys):
    """``--data-parallel 2`` gives the one-shard run's tokens and cache
    bytes on every engine of the example."""
    argv = ["--smoke", "--device", "cpu", "--requests", "4", "--gen-tokens",
            "5", "--slots", "4", "--paged", "--page-size", "16",
            "--prefill-chunk", "16", "--prefill-slots", "2"]
    mod = _load_example()

    def lines(extra):
        capsys.readouterr()
        mod.main(argv + extra)
        out = capsys.readouterr().out.splitlines()
        return ([x for x in out if "req0 tokens" in x],
                [x.split("|")[-1] for x in out if "reqs," in x])
    toks1, bytes1 = lines([])
    toks2, bytes2 = lines(["--data-parallel", "2"])
    assert len(toks1) == 3 and toks2 == toks1
    assert bytes2 == bytes1


class _Clock:
    """A clock that advances 1 ms per reading: the bench's wall-clock
    gate compares equal step times."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1e-3
        return self.t


def test_bench_smoke_gates_pass_at_dp8(tmp_path, monkeypatch):
    """The ported bench's --smoke run at dp = 8 on the CPU: every gate
    passes (its p99 instrumentation gate reads a virtual clock: host
    wall times on a shared CPU are noise at this size), and the harness
    folds the artifact."""
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path))
    monkeypatch.setattr(bench_sharded_serve, "time", _Clock())
    bench_sharded_serve.main(["--smoke", "--device", "cpu"])
    art = json.loads((tmp_path / "BENCH_sharded_serve_torch.json").read_text())
    assert art["ok"] and art["extra"]["dp"] == 8
    gates = {g["name"]: g["passed"] for g in art["gates"]}
    assert all(gates.values()) and {
        "token_identity", "one_dispatch_per_step", "no_per_shard_dispatch",
        "no_extra_steps", "no_extra_dispatches", "obs_overhead_p99"} <= set(
            gates)
    summary = bench_run.aggregate()
    assert summary["benches"]["sharded_serve_torch"]["ok"]
    assert not summary["gates_failed"]


def test_sharded_paths_run_without_jax(tmp_path):
    """The launcher's ``--data-parallel`` and the split-S decode under
    rules run with neither ``jax`` nor any ``repro.`` module imported."""
    import os
    import subprocess
    code = (
        "import sys, torch\n"
        "from repro_torch.launch import serve\n"
        "from repro_torch.launch.mesh import make_mesh\n"
        "from repro_torch.sharding.api import P, ShardingRules, use_rules\n"
        "eng = serve.main(['--arch', 'llama3-8b', '--smoke', '--swan', '--k',"
        " '8', '--buffer', '8', '--tokens', '3', '--batch', '4',"
        " '--prompt-len', '12', '--max-seq', '64', '--engine', '--paged',"
        " '--page-size', '16', '--prefill-chunk', '8', '--prefill-slots',"
        " '2', '--data-parallel', '2', '--device', 'cpu'])\n"
        "assert eng.dp == 2\n"
        "cfg, api = eng.cfg, eng.api\n"
        "st = api.init_serve_state(cfg, eng.swan, 2, 64, 'cpu')\n"
        "toks = torch.zeros((2, 8), dtype=torch.long)\n"
        "api.prefill(eng.params, cfg, {'tokens': toks}, st, eng.swan,"
        " eng.projections)\n"
        "mesh = make_mesh((2,), ('model',), ['cpu'] * 2)\n"
        "with use_rules(ShardingRules(mesh, {'swan_sparse':"
        " P(None, None, 'model', None)})):\n"
        "    api.decode_step(eng.params, cfg, toks[:, -1],"
        " torch.full((2,), 8), st, eng.swan, eng.projections)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.split('.')[0] in ('repro', 'benchmarks')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH="src", REPRO_BENCH_OUT=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=str(Path(__file__).resolve().parents[1]),
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
