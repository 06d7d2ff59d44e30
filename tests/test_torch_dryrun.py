"""The port's dry-run (``repro_torch.launch.dryrun``) held to the
reference's on the same mini meshes: ``(2, 4)`` over ('data', 'model')
and ``(2, 2, 2)`` over ('pod', 'data', 'model'), ``n_layers=2``.  The
reference compiles on 8 host devices in one subprocess; the port traces
each cell over a fake process group of 8 ranks in a subprocess of its own
(the fake default group must not live in a pytest worker), all side by
side.

Bounds (per device): argument bytes equal; output bytes equal up to the
named differences; flops within 15 % of the reference's ``hlo_cost``
(olmo-1b's multi-pod decode is held to its measured band, cause below);
collective bytes nonzero where the reference's are and within 4x; the
same bottleneck.  Byte and temp ratios are printed, not bounded."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CELLS = [("llama3-8b", "decode_32k", False, True),
         ("llama3-8b", "train_4k", False, False),
         ("llama3-8b", "prefill_32k", False, True),
         ("olmo-1b", "decode_32k", True, True)]
IDS = [f"{a}-{s}-{'mp' if m else 'sp'}{'-swan' if w else ''}"
       for a, s, m, w in CELLS]

# olmo-1b decode on (2, 2, 2): the port counts 0.835x of the reference's
# flops.  Its matmuls (7.66e9) are the projections and the head; the split-S
# gathers add 3.3e9 of multiplies and sums; the reference's HLO also
# charges flops to ops the eager count charges none (the value side's
# scatter-add, 1.07e9 at one flop per update, and its converts and
# selects), which at d_model 2048 and G = 1 is a larger share of the step
# than at llama3-8b's widths.  ROADMAP §C.
FLOPS_BAND = {"olmo-1b-decode_32k-mp-swan": (0.80, 0.87)}

# the cells that ``--all --sample-depth --jobs 2`` traces (every other
# cell's record is already there); the SWAN one is the full-depth CLI
# run's cell
SAMPLED = [("olmo-1b", "decode_32k", False, False),
           ("olmo-1b", "decode_32k", False, True)]

_REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
sys.path.insert(0, "src")
import json
import repro.launch.dryrun as dr
import repro.launch.mesh as mesh_mod
from repro.analysis.report import dryrun_table
mesh_mod.make_production_mesh = lambda multi_pod=False: mesh_mod.make_mesh(
    (2, 2, 2) if multi_pod else (2, 4),
    ("pod", "data", "model") if multi_pod else ("data", "model"))
dr.make_production_mesh = mesh_mod.make_production_mesh
cells = json.loads(sys.argv[1])
recs = [dr.build_cell(a, s, m, w, overrides={"n_layers": 2})
        for a, s, m, w in cells]
print(json.dumps({"recs": recs, "table": dryrun_table(recs),
                  "iter_sp": list(dr.iter_cells(False)),
                  "iter_mp": list(dr.iter_cells(True))}))
"""

_PORT = r"""
import sys
sys.path.insert(0, "src")
import json
import repro_torch.launch.dryrun as dr
import repro_torch.launch.mesh as mesh_mod
make = mesh_mod.make_dryrun_mesh
mesh_mod.make_dryrun_mesh = lambda multi_pod=False: make(
    shape=(2, 2, 2) if multi_pod else (2, 4))
a, s, m, w = json.loads(sys.argv[1])
print(json.dumps(dr.build_cell(a, s, m, w, overrides={"n_layers": 2})))
"""


# the grad_accum loop: olmo-1b's train step at 1 layer and 2 microbatches
# on the (2, 4) mesh, traced as the dry-run traces it (one trip counted
# twice) and with the loop run whole
_ACCUM = r"""
import sys
sys.path.insert(0, "src")
import json
import repro_torch.launch.dryrun as dr
import repro_torch.launch.mesh as mesh_mod
from repro_torch.runtime import train_loop
make = mesh_mod.make_dryrun_mesh
mesh_mod.make_dryrun_mesh = lambda multi_pod=False: make(shape=(2, 4))
real = train_loop.make_train_step
out = {}
for count_only in (True, False):
    dr.make_train_step = lambda *a, **k: real(
        *a, **{**k, "count_only": count_only})
    out[str(count_only)] = dr.build_cell(
        "olmo-1b", "train_4k", False, False,
        overrides={"n_layers": 1, "grad_accum": 2})
print(json.dumps(out))
"""


def _last_json(out: str):
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's records, table and cell lists; the port's records;
    and the port CLI's record for olmo-1b decode_32k with SWAN on the
    full 256-rank mesh (two layers), all run side by side."""
    out_dir = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"}

    def start(args):
        return subprocess.Popen([sys.executable] + args, cwd=REPO, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    procs = {"ref": start(["-c", _REF, json.dumps(CELLS)])}
    for cid, cell in zip(IDS, CELLS):
        procs[cid] = start(["-c", _PORT, json.dumps(cell)])
    procs["accum"] = start(["-c", _ACCUM])
    procs["cli"] = start(["-m", "repro_torch.launch.dryrun", "--arch",
                          "olmo-1b", "--shape", "decode_32k", "--swan",
                          "--set", "n_layers=2", "--out", str(out_dir)])
    # --all over a directory that holds every other cell's record: only
    # the SAMPLED cells run, two processes at once, each traced at 0 and 1
    # layer and extended to 2
    from repro_torch.launch.dryrun import _cell_tag, iter_cells
    sample_dir = tmp_path_factory.mktemp("dryrun_sampled")
    for cell in iter_cells(False):
        if cell not in SAMPLED:
            (sample_dir / (_cell_tag(*cell) + ".json")).write_text("{}")
    procs["sampled"] = start(["-m", "repro_torch.launch.dryrun", "--all",
                              "--skip-existing", "--jobs", "2",
                              "--sample-depth", "--set", "n_layers=2",
                              "--out", str(sample_dir)])
    res = {}
    for name, p in procs.items():
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, (name, err[-3000:])
        res[name] = out
    ref = _last_json(res["ref"])
    port = {cid: _last_json(res[cid]) for cid in IDS}
    with open(out_dir / "olmo-1b__decode_32k__sp__swan.json",
              encoding="utf-8") as f:
        cli = json.load(f)
    sampled = {"log": res["sampled"]}
    for cell in SAMPLED:
        with open(sample_dir / (_cell_tag(*cell) + ".json"),
                  encoding="utf-8") as f:
            sampled[cell] = json.load(f)
    sampled["accum"] = _last_json(res["accum"])
    return ref, port, cli, sampled


def _pair(runs, cid):
    ref, port = runs[:2]
    r = ref["recs"][IDS.index(cid)]
    p = port[cid]
    assert r["status"] == "ok" and p["status"] == "ok", p.get("error")
    return r, p


@pytest.mark.parametrize("cid", IDS)
def test_argument_bytes_equal(runs, cid):
    r, p = _pair(runs, cid)
    assert p["memory"]["argument_bytes"] == r["memory"]["argument_bytes"]
    print(cid, {k: round(p["memory"][k] / max(r["memory"][k], 1), 3)
                for k in ("output_bytes", "temp_bytes", "alias_bytes")},
          "hbm", round(p["step_cost"]["hbm_bytes"]
                       / r["hlo_cost"]["hbm_bytes"], 3))


@pytest.mark.parametrize("cid", IDS)
def test_output_bytes_equal_up_to_named_differences(runs, cid):
    """Equal within a few scalars' bytes, but for the SWAN decode cells:
    the reference's compiled step returns the dense rings (``buf_k``,
    ``buf_v``, donated with the whole state) split over 'model' as well,
    a layout its propagation picks for the outputs, so it does not alias
    them; the port updates every state leaf in place and returns it in
    its input layout.  The difference is the rings' local bytes times
    (1 - 1/n_model)."""
    r, p = _pair(runs, cid)
    diff = p["memory"]["output_bytes"] - r["memory"]["output_bytes"]
    if cid.startswith(("llama3-8b-decode", "olmo-1b-decode")):
        cell = CELLS[IDS.index(cid)]
        n_model = 2 if cell[2] else 4
        ring = p["memory"]["alias_bytes"] - r["memory"]["alias_bytes"]
        assert ring == 2 ** 26                  # the rings: 64 MiB / device
        diff -= ring * (1 - 1 / n_model)
    assert abs(diff) <= 1024, diff


@pytest.mark.parametrize("cid", IDS)
def test_flops_within_bound(runs, cid):
    r, p = _pair(runs, cid)
    ratio = p["step_cost"]["flops"] / r["hlo_cost"]["flops"]
    lo, hi = FLOPS_BAND.get(cid, (0.85, 1.15))
    assert lo <= ratio <= hi, ratio


@pytest.mark.parametrize("cid", IDS)
def test_collectives_within_4x(runs, cid):
    r, p = _pair(runs, cid)
    rb, pb = r["hlo_cost"]["collective_bytes"], p["step_cost"][
        "collective_bytes"]
    assert (pb > 0) == (rb > 0)
    if rb:
        assert 0.25 <= pb / rb <= 4.0, pb / rb


@pytest.mark.parametrize("cid", IDS)
def test_same_bottleneck(runs, cid):
    r, p = _pair(runs, cid)
    assert p["roofline"]["bottleneck"] == r["roofline"]["bottleneck"]
    assert p["n_devices"] == r["n_devices"] == 8


def test_iter_cells_equal_the_reference(runs):
    from repro_torch.launch.dryrun import iter_cells
    ref = runs[0]
    assert [list(c) for c in iter_cells(False)] == ref["iter_sp"]
    assert [list(c) for c in iter_cells(True)] == ref["iter_mp"]


def test_dryrun_table_matches_the_reference(runs):
    from repro_torch.analysis.report import dryrun_table
    ref = runs[0]
    recs = [{("step_cost" if k == "hlo_cost" else k): v
             for k, v in r.items()} for r in ref["recs"]]
    assert dryrun_table(recs) == ref["table"]


def test_cli_record(runs):
    cli = runs[2]
    assert cli["status"] == "ok", cli.get("error")
    assert cli["n_devices"] == 256
    assert cli["roofline"]["kernel_model_memory_s"] > 0
    assert set(cli["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes"}
    assert "trace_s" in cli and "replicated_ops" in cli


def test_sampled_depth_extends_to_the_full_trace(runs):
    """``--all --skip-existing --jobs 2 --sample-depth`` runs only the
    missing cells, in processes of their own, and ends with no failure;
    the SWAN decode cell's counts, traced at 0 and 1 layer and extended
    to 2, equal the full 2-layer trace's within 1 %."""
    from repro_torch.launch.dryrun import iter_cells
    cli, sampled = runs[2], runs[3]
    assert "dry-run finished, failures: 0" in sampled["log"]
    assert sampled["log"].count("[skip existing]") == len(
        list(iter_cells(False))) - len(SAMPLED)
    for cell in SAMPLED:
        rec = sampled[cell]
        assert rec["status"] == "ok", rec.get("error")
        assert rec["depth_sampled"] == {"traced_layers": [0, 1], "layers": 2}
    rec = sampled[SAMPLED[1]]
    assert rec["memory"]["argument_bytes"] == cli["memory"]["argument_bytes"]
    for k in ("flops", "hbm_bytes", "collective_bytes"):
        got, want = rec["step_cost"][k], cli["step_cost"][k]
        assert abs(got - want) <= 0.01 * want, (k, got, want)


def test_accumulation_counts_one_trip_as_the_whole_loop(runs):
    """The dry-run traces the real train step with ``count_only``: its
    ``grad_accum`` loop runs one microbatch, counted ``grad_accum`` times;
    that equals the loop run whole (flops exactly; bytes and collective
    bytes within a scalar's worth of the loss's sum)."""
    acc = runs[3]["accum"]
    one, whole = acc["True"], acc["False"]
    assert one["status"] == whole["status"] == "ok", one.get("error")
    assert one["memory"]["argument_bytes"] == whole["memory"]["argument_bytes"]
    assert one["step_cost"]["flops"] == whole["step_cost"]["flops"]
    for k in ("hbm_bytes", "collective_bytes"):
        got, want = one["step_cost"][k], whole["step_cost"][k]
        assert abs(got - want) <= 1e-6 * want, (k, got, want)


def test_a_real_train_step_stays_strict():
    """Outside the dry-run, a parameter the loss does not read (a layer
    stack cut to 0 layers) raises; ``count_only`` gives it zero
    gradients."""
    import torch
    from repro_torch.configs import OptimizerConfig, get_smoke_config
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.runtime.train_loop import make_train_step

    cfg = get_smoke_config("olmo-1b").replace(n_layers=0)
    opt = OptimizerConfig()
    batch = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 9)), dtype=torch.int32)}
    for accum in (1, 2):
        params = get_model(cfg).init_params(cfg, 0, "cpu")
        with pytest.raises(RuntimeError, match="not have been used"):
            make_train_step(cfg, opt, accum)(params, init_opt_state(
                params, opt), batch)
        params = get_model(cfg).init_params(cfg, 0, "cpu")
        _, _, m = make_train_step(cfg, opt, accum, count_only=True)(
            params, init_opt_state(params, opt), batch)
        assert torch.isfinite(m["loss"])
