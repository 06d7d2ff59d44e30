"""The port's lockstep serving against the JAX ``ServeSession`` on the
float32 llama3-8b smoke config: the reference's weights, absorbed weights
and projections carried across, greedy tokens identical at k = d_head/2
and at full retention; the port's own calibration lossless at full
retention; and the port's isolation from JAX and its device contract."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import SwanConfig as JSwan  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch.io import make_batch as j_make_batch  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.runtime.serve_loop import ServeSession as JSession  # noqa: E402
from repro.runtime.serve_loop import calibrate_swan as j_calibrate  # noqa: E402
from repro_torch.configs import SwanConfig, get_smoke_config  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch.io import make_batch  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.runtime.serve_loop import ServeSession, calibrate_swan  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def ref():
    """The reference's quickstart pipeline at f32, and its tensors in torch."""
    jcfg = j_smoke("llama3-8b").replace(dtype="float32", param_dtype="float32")
    tcfg = get_smoke_config("llama3-8b").replace(dtype="float32",
                                                 param_dtype="float32")
    japi = j_get_model(jcfg)
    params = japi.init_params(jax.random.PRNGKey(0), jcfg)
    pj = j_calibrate(japi, jcfg, params, j_make_batch(jcfg, 2, 24, seed=3))
    absorbed = japi.absorb(params, jcfg, pj)
    t = {n: to_torch(x, device="cpu") for n, x in
         (("params", params), ("absorbed", absorbed), ("pj", pj))}
    return jcfg, tcfg, params, absorbed, pj, t


@pytest.mark.parametrize("k_frac", ["half", "full"])
def test_greedy_tokens_match_reference_session(ref, k_frac):
    jcfg, tcfg, _, absorbed, pj, t = ref
    k = jcfg.d_head // 2 if k_frac == "half" else jcfg.d_head
    jsess = JSession(jcfg, absorbed, swan=JSwan(k_max=k, buffer=8), projections=pj,
                     max_seq=64, batch=2)
    tsess = ServeSession(tcfg, t["absorbed"], swan=SwanConfig(k_max=k, buffer=8),
                         projections=t["pj"], max_seq=64, batch=2, device="cpu")
    j_out = jsess.generate(j_make_batch(jcfg, 2, 16, seed=1), 14)
    t_out = tsess.generate(make_batch(tcfg, 2, 16, seed=1, device="cpu"), 14)
    np.testing.assert_array_equal(np.asarray(j_out), t_out.numpy())
    assert tsess.cache_report() == jsess.cache_report()


def test_dense_session_matches_reference(ref):
    jcfg, tcfg, params, _, _, t = ref
    j_out = JSession(jcfg, params, max_seq=64, batch=2).generate(
        j_make_batch(jcfg, 2, 12, seed=2), 10)
    t_out = ServeSession(tcfg, t["params"], max_seq=64, batch=2,
                         device="cpu").generate(
        make_batch(tcfg, 2, 12, seed=2, device="cpu"), 10)
    np.testing.assert_array_equal(np.asarray(j_out), t_out.numpy())


def test_own_calibration_full_retention_matches_dense(ref):
    _, tcfg, _, _, _, t = ref
    api = get_model(tcfg)
    params = api.init_params(tcfg, 7, "cpu")
    pj = calibrate_swan(api, tcfg, params,
                        make_batch(tcfg, 2, 24, seed=3, device="cpu"))
    swan = SwanConfig(k_max=tcfg.d_head, buffer=8)
    dense = ServeSession(tcfg, params, max_seq=64, batch=2, device="cpu")
    full = ServeSession(tcfg, api.absorb(params, tcfg, pj), swan=swan,
                        projections=pj, max_seq=64, batch=2, device="cpu")
    prompt = make_batch(tcfg, 2, 20, seed=4, device="cpu")
    ld, ls = dense.prefill(prompt), full.prefill(prompt)
    for _ in range(8):                  # decode well past the ring (b=8)
        np.testing.assert_allclose(ls.numpy(), ld.numpy(), atol=5e-5)
        tok = torch.argmax(ld, dim=-1)
        ld, ls = dense.decode(tok), full.decode(tok)
    np.testing.assert_allclose(ls.numpy(), ld.numpy(), atol=5e-5)


def test_session_defaults_to_the_card(ref):
    _, tcfg, _, _, _, t = ref
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeSession(tcfg, t["params"], max_seq=32, batch=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batch(tcfg, 1, 4)


def test_launcher_runs_on_cpu(capsys):
    serve_cli.main(["--arch", "llama3-8b", "--smoke", "--swan", "--k", "8",
                    "--buffer", "8", "--tokens", "4", "--batch", "2",
                    "--prompt-len", "12", "--max-seq", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "seq 0:" in out and "cache [swan[topk]]" in out


def test_port_runs_without_jax_or_the_reference(tmp_path):
    """The lockstep session, the paged, chunked engine (with its graph
    family enumerated by ``runtime.warmup``), the launcher with
    ``--metrics-out``, ``--trace-out`` and ``--profile-steps``, the serve
    benchmarks, the kernel microbenchmark (all six kernels' wrappers),
    a lockstep session of a MoE smoke config (``models.moe``, q/k/v
    biases) and lockstep SWAN sessions of the VLM (patch embeddings, G =
    7) and the encoder-decoder (``models.encdec``, the compressed cross
    cache) smoke configs, a lockstep SWAN session and an engine of the
    hybrid smoke config (``models.jamba``, ``models.mamba``) and an engine
    of the RWKV one (``models.rwkv_model``), and the analysis layer (the
    cost analyzer over a decode step, a roofline report, swanlint over the
    port's tree, the serve auditor's prechecks) run on the CPU with neither
    ``jax`` nor any ``repro.`` or ``benchmarks`` module imported."""
    code = (
        "import sys\n"
        "from repro_torch.configs import SwanConfig, get_smoke_config\n"
        "from repro_torch.launch.io import make_batch\n"
        "from repro_torch.models.registry import get_model\n"
        "from repro_torch.runtime.serve_loop import ServeSession, calibrate_swan\n"
        "import repro_torch.launch.serve, repro_torch.convert, repro_torch.kernels\n"
        "import repro_torch.runtime.warmup, repro_torch.runtime.graphs\n"
        "cfg = get_smoke_config('llama3-8b')\n"
        "api = get_model(cfg)\n"
        "p = api.init_params(cfg, 0, 'cpu')\n"
        "pj = calibrate_swan(api, cfg, p, make_batch(cfg, 2, 16, device='cpu'))\n"
        "s = ServeSession(cfg, api.absorb(p, cfg, pj), swan=SwanConfig(k_max=8,"
        " buffer=4), projections=pj, max_seq=32, batch=2, device='cpu')\n"
        "out = s.generate(make_batch(cfg, 2, 8, device='cpu'), 4)\n"
        "from repro_torch.runtime.serve_engine import Request, ServeEngine\n"
        "e = ServeEngine(cfg, api.absorb(p, cfg, pj), swan=SwanConfig(k_max=8,"
        " buffer=4), projections=pj, max_seq=32, n_slots=2, paged=True,"
        " page_size=8, prefill_chunk=8, prefill_slots=2, device='cpu')\n"
        "done = e.run([Request(uid=i, tokens=list(range(3, 3 + 5 * i)),"
        " max_new_tokens=3, k=4) for i in (1, 2, 3)])\n"
        "assert sorted(len(c.tokens) for c in done) == [3, 3, 3]\n"
        "fam = repro_torch.runtime.warmup.executable_family(e)\n"
        "assert fam['expected']['chunk']['paged'] > 0\n"
        "repro_torch.launch.serve.main(['--arch', 'llama3-8b', '--smoke',"
        " '--swan', '--k', '8', '--buffer', '8', '--tokens', '3', '--batch',"
        " '2', '--prompt-len', '12', '--max-seq', '64', '--device', 'cpu',"
        " '--engine', '--paged', '--page-size', '16', '--prefill-chunk', '8',"
        f" '--metrics-out', {str(tmp_path / 'm.prom')!r}, '--trace-out',"
        f" {str(tmp_path / 't.jsonl')!r}, '--profile-steps', '2',"
        f" '--profile-dir', {str(tmp_path / 'prof')!r}])\n"
        "from repro_torch.obs import EventTrace, parse_prometheus\n"
        f"m = parse_prometheus(open({str(tmp_path / 'm.prom')!r}).read())\n"
        "assert m['samples'][('serve_tokens_generated_total', ())] == 12\n"
        f"assert EventTrace.read({str(tmp_path / 't.jsonl')!r})\n"
        "from repro_torch.benchmarks import bench_serve_engine, "
        "bench_paged_cache, bench_warmup\n"
        "from repro_torch.benchmarks import bench_kernels\n"
        "import repro_torch.analysis.roofline\n"
        "import repro_torch.kernels.flash_prefill.ops\n"
        "import repro_torch.kernels.swan_prune.ops\n"
        "rec = bench_kernels.run(smoke=True, device='cpu')\n"
        "assert len(rec.extra['roofline']) == 7\n"
        "import repro_torch.models.moe\n"
        "mcfg = get_smoke_config('qwen2-moe-a2.7b')\n"
        "mapi = get_model(mcfg)\n"
        "mp = mapi.init_params(mcfg, 0, 'cpu')\n"
        "mpj = calibrate_swan(mapi, mcfg, mp, make_batch(mcfg, 2, 16, device='cpu'))\n"
        "ms = ServeSession(mcfg, mapi.absorb(mp, mcfg, mpj), swan=SwanConfig("
        "k_max=8, buffer=4), projections=mpj, max_seq=32, batch=2, device='cpu')\n"
        "assert tuple(ms.generate(make_batch(mcfg, 2, 8, device='cpu'), 4)"
        ".shape) == (2, 4)\n"
        "import repro_torch.models.encdec\n"
        "for arch in ('internvl2-1b', 'whisper-small'):\n"
        "    xcfg = get_smoke_config(arch)\n"
        "    xapi = get_model(xcfg)\n"
        "    xp = xapi.init_params(xcfg, 0, 'cpu')\n"
        "    xpj = calibrate_swan(xapi, xcfg, xp, make_batch(xcfg, 2, 16,"
        " device='cpu'))\n"
        "    xs = ServeSession(xcfg, xapi.absorb(xp, xcfg, xpj), swan="
        "SwanConfig(k_max=4, buffer=4, compress_cross_attn=True),"
        " projections=xpj, max_seq=32, batch=2, device='cpu')\n"
        "    xo = xs.generate(make_batch(xcfg, 2, 8, device='cpu'), 4)\n"
        "    assert tuple(xo.shape) == (2, 4), arch\n"
        "    assert xs.pos == 8 + 3 + xcfg.n_prefix_tokens, (arch, xs.pos)\n"
        "import repro_torch.models.jamba, repro_torch.models.rwkv_model\n"
        "hcfg = get_smoke_config('jamba-1.5-large-398b')\n"
        "hapi = get_model(hcfg)\n"
        "hp = hapi.init_params(hcfg, 0, 'cpu')\n"
        "hpj = calibrate_swan(hapi, hcfg, hp, make_batch(hcfg, 2, 16,"
        " device='cpu'))\n"
        "hs = ServeSession(hcfg, hapi.absorb(hp, hcfg, hpj), swan=SwanConfig("
        "k_max=8, buffer=4), projections=hpj, max_seq=32, batch=2,"
        " device='cpu')\n"
        "assert tuple(hs.generate(make_batch(hcfg, 2, 8, device='cpu'), 4)"
        ".shape) == (2, 4)\n"
        "for rc, rw in ((hcfg, hp), (get_smoke_config('rwkv6-3b'), None)):\n"
        "    rw = rw if rw is not None else get_model(rc).init_params(rc, 0,"
        " 'cpu')\n"
        "    re = ServeEngine(rc, rw, max_seq=32, n_slots=2, device='cpu')\n"
        "    rd = re.run([Request(uid=i, tokens=list(range(3, 3 + 4 * i)),"
        " max_new_tokens=3) for i in (1, 2, 3)])\n"
        "    assert sorted(len(c.tokens) for c in rd) == [3, 3, 3], rc.name\n"
        "import repro_torch.analysis.cost, repro_torch.analysis.report\n"
        "import repro_torch.analysis.lint, repro_torch.analysis.lint.audit\n"
        "from repro_torch.analysis.cost import analyze_step\n"
        "c = analyze_step(s.decode, out[:, -1])\n"
        "assert c.flops_of('matmul') > 0 and c.host_transfers == 0\n"
        "from repro_torch.configs import SHAPES\n"
        "rep = repro_torch.analysis.roofline.roofline_report({'step_cost':"
        " c.to_json(), 'n_devices': 1}, cfg, SHAPES['decode_32k'])\n"
        "assert rep['model_flops'] > 0\n"
        f"assert not [f for f in repro_torch.analysis.lint.run_lint({str(SRC.parent)!r})"
        " if not f.suppressed]\n"
        "assert all(ck.status == 'pass' for ck in repro_torch.analysis.lint"
        ".audit.kernel_precheck_checks(cfg, SwanConfig(k_max=8, buffer=4), 32,"
        " page_size=8, chunk_q=16))\n"
        "import repro_torch.sharding.specs, repro_torch.sharding.serve_specs\n"
        "import repro_torch.benchmarks.run\n"
        "from repro_torch.configs import get_config\n"
        "lcfg = get_config('llama3-405b')\n"
        "lp = get_model(lcfg).init_params(lcfg, 0, 'meta')\n"
        "class Mesh:\n"
        "    shape = {'data': 16, 'model': 16}\n"
        "    axis_names = ('data', 'model')\n"
        "assert repro_torch.sharding.specs.params_pspecs(lp, lcfg, Mesh())"
        "['embed'] == ('model', 'data')\n"
        "assert not repro_torch.sharding.serve_specs.unspecced_serve_leaves("
        "e.state)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.split('.')[0] in ('repro', 'benchmarks')]\n"
        "assert not bad, bad\n"
        "print(tuple(out.shape))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(SRC)
    env["REPRO_BENCH_OUT"] = str(tmp_path)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "(2, 4)"
