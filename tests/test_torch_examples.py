"""The port's examples (``examples/torch_{quickstart,serve_batched,
long_context_decode}.py``) at ``--smoke --device cpu`` against the
reference's examples, with the reference's JAX-initialised weights carried
across: the printed tokens, cache bytes, steps and tables equal (times
aside); and each example runs for the other dense archs."""
import importlib.util
import re
import sys
from pathlib import Path

import jax
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
F32 = dict(dtype="float32", param_dtype="float32")
# each reference example's model: the llama3-8b smoke config, reshaped
SHAPES = {
    "quickstart": {},
    "serve_batched": dict(n_layers=4, d_model=128, n_heads=8, n_kv_heads=4,
                          d_head=16, d_ff=256),
    "long_context_decode": dict(n_layers=3, d_model=96, n_heads=6,
                                n_kv_heads=2, d_head=16, d_ff=192),
}
# a small serve_batched trace: both packages' engines run it
BATCHED_ARGV = ["--requests", "4", "--gen-tokens", "5", "--slots", "2",
                "--paged", "--page-size", "16", "--prefill-chunk", "16",
                "--prefill-slots", "2"]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(capsys, fn, *args, **kwargs) -> list:
    capsys.readouterr()
    fn(*args, **kwargs)
    return capsys.readouterr().out.splitlines()


def _untimed(line: str) -> str:
    """A printed line without its wall-clock figures."""
    return re.sub(r"in +[\d.]+ ms \( *[\d.]+ tok/s, ", "in - (", line)


@pytest.mark.parametrize("name", list(SHAPES))
def test_example_matches_reference(name, capsys, monkeypatch):
    jcfg = j_smoke("llama3-8b").replace(**F32, **SHAPES[name])
    params = j_get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    argv = BATCHED_ARGV if name == "serve_batched" else []
    monkeypatch.setattr(sys, "argv", [name] + argv)
    want = _run(capsys, _load(name).main)
    got = _run(capsys, _load(f"torch_{name}").main,
               ["--smoke", "--device", "cpu"] + argv,
               params=to_torch(params, device="cpu"))
    if name == "serve_batched":
        # the port also prints each engine's first request's tokens, and
        # counts decode graphs where the reference counts executables
        got = [_untimed(x) for x in got if "req0 tokens" not in x
               and "decode graphs" not in x]
        want = [_untimed(x) for x in want if "decode executables" not in x]
    assert got == want


@pytest.mark.parametrize("arch", ["yi-9b", "olmo-1b"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_example_runs_for_the_dense_archs(name, arch, capsys):
    argv = ["--arch", arch, "--smoke", "--device", "cpu"]
    if name == "serve_batched":
        argv += BATCHED_ARGV
    out = "\n".join(_run(capsys, _load(f"torch_{name}").main, argv))
    assert {"quickstart": "losslessness check (Lemmas A.1/A.2): PASS",
            "serve_batched": "pool live bytes followed generated tokens",
            "long_context_decode": "runtime knob"}[name] in out


def test_examples_and_benches_run_without_jax(tmp_path):
    """The three examples, the analytical benches and the prefill benches
    run on the CPU with neither ``jax`` nor any ``repro.`` or
    ``benchmarks`` module imported."""
    import os
    import subprocess
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(EXAMPLES)!r})\n"
        "import torch_quickstart, torch_serve_batched, torch_long_context_decode\n"
        "torch_quickstart.main(['--arch', 'olmo-1b', '--smoke', '--device', 'cpu'])\n"
        "torch_serve_batched.main(['--arch', 'yi-9b', '--smoke', '--device',"
        " 'cpu', '--requests', '2', '--gen-tokens', '3'])\n"
        "torch_long_context_decode.main(['--smoke', '--device', 'cpu'])\n"
        "from repro_torch.benchmarks import (bench_breakeven,"
        " bench_fig2a_compression, bench_memory_footprint,"
        " bench_chunked_prefill, bench_concurrent_prefill)\n"
        "for b in (bench_breakeven, bench_fig2a_compression,"
        " bench_memory_footprint):\n"
        "    b.run()\n"
        "bench_concurrent_prefill.run(smoke=True, device='cpu')\n"
        "import repro_torch.launch.train\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.split('.')[0] in ('repro', 'benchmarks')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(EXAMPLES.parent / "src")
    env["REPRO_BENCH_OUT"] = str(tmp_path)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "clean"
