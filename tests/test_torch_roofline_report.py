"""The port's roofline and report (``repro_torch.analysis.{roofline,report}``)
against the reference's (``repro.analysis.{roofline,report}``):
``model_flops`` over every arch the port registers x every shape,
``kernel_model_bytes`` at the reference's 256 devices over every
SWAN-applicable arch x decode shape, ``roofline_report`` on one record
(the machine constants differ, so the terms are compared as counts), and
``roofline_table``/``summary_stats`` rendering the same rows from the same
records."""
import json

import pytest

from repro.analysis import report as ref_report
from repro.analysis import roofline as ref_rl
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import SwanConfig as JSwan
from repro.configs import get_config as j_config
from repro_torch.analysis import report, roofline
from repro_torch.configs import ARCH_IDS, SHAPES, SwanConfig, get_config
from repro_torch.models.registry import swan_applicable

SWANS = [dict(k_max=64, buffer=128), dict(k_max=32, buffer=64, quantize=True),
         dict(k_max=48, buffer=0, mode="truncate")]
# (flops, hbm bytes, collective bytes) far from both machines' ridges
RECORDS = [(4e15, 1e9, 0.0), (1e9, 2e12, 0.0), (1e9, 1e9, 1e13),
           (0.0, 0.0, 0.0)]


def test_shapes_match_the_reference():
    assert {n: (s.kind, s.seq_len, s.global_batch)
            for n, s in SHAPES.items()} == \
        {n: (s.kind, s.seq_len, s.global_batch)
         for n, s in REF_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_the_reference(arch):
    cfg, jcfg = get_config(arch), j_config(arch)
    for name, shape in SHAPES.items():
        assert roofline.model_flops(cfg, shape) == \
            ref_rl.model_flops(jcfg, REF_SHAPES[name]), name
    # n_tokens replaces the token count
    d = SHAPES["decode_32k"]
    assert roofline.model_flops(cfg, d, n_tokens=4) == \
        2.0 * cfg.n_active_params() * 4


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if swan_applicable(get_config(a))])
def test_kernel_model_bytes_match_the_reference_at_256_devices(arch):
    cfg, jcfg = get_config(arch), j_config(arch)
    for name, shape in SHAPES.items():
        if shape.kind != "decode":
            continue
        for kw in SWANS:
            mine = roofline.kernel_model_bytes(cfg, shape, SwanConfig(**kw),
                                               n_dev=256)
            ref = ref_rl.kernel_model_bytes(jcfg, REF_SHAPES[name],
                                            JSwan(**kw))
            assert mine == ref, (name, kw)
            assert roofline.kernel_model_bytes(
                cfg, shape, SwanConfig(**kw)) // 256 == mine


def _record(flops, nbytes, coll, n_dev=4, arch="llama3-8b",
            shape="decode_32k", swan=True, status="ok", multi_pod=False):
    cost = {"flops": flops, "hbm_bytes": nbytes, "collective_bytes": coll,
            "per_collective": {"all-reduce": coll} if coll else {},
            "collective_count": int(bool(coll)), "host_transfers": 0}
    return {"arch": arch, "shape": shape, "swan": swan, "status": status,
            "multi_pod": multi_pod, "n_devices": n_dev, "hlo_cost": cost,
            "step_cost": cost}


@pytest.mark.parametrize("flops,nbytes,coll", RECORDS)
def test_roofline_report_matches_the_reference(flops, nbytes, coll):
    cfg, jcfg = get_config("llama3-8b"), j_config("llama3-8b")
    rec = _record(flops, nbytes, coll)
    mine = roofline.roofline_report(rec, cfg, SHAPES["decode_32k"],
                                    SwanConfig())
    ref = ref_rl.roofline_report(rec, jcfg, REF_SHAPES["decode_32k"],
                                 JSwan())
    for key in ("model_flops", "useful_flops_ratio", "bottleneck"):
        assert mine[key] == ref[key], key
    assert mine["compute_s"] * roofline.PEAK_FLOPS == \
        pytest.approx(ref["compute_s"] * ref_rl.PEAK_FLOPS, rel=1e-12)
    assert mine["memory_s"] * roofline.HBM_BW == \
        pytest.approx(ref["memory_s"] * ref_rl.HBM_BW, rel=1e-12)
    assert mine["collective_s"] * roofline.NVLINK_BW == \
        pytest.approx(ref["collective_s"] * ref_rl.ICI_BW, rel=1e-12)
    # the reference divides the kernel bytes over its 256-chip pod, the
    # port over the record's devices
    assert mine["kernel_model_bytes"] * 4 // 256 == pytest.approx(
        ref["kernel_model_bytes"], abs=1)
    assert "VMEM" not in mine["advice"]


def _records():
    cfg = get_config("llama3-8b")
    jcfg = j_config("llama3-8b")
    out = []
    for i, (f, b, c) in enumerate(RECORDS[:3]):
        for multi in (False, True):
            r = _record(f, b, c, shape=["decode_32k", "prefill_32k",
                                        "train_4k"][i],
                        swan=bool(i % 2), multi_pod=multi)
            r["roofline"] = ref_rl.roofline_report(r, jcfg,
                                                   REF_SHAPES[r["shape"]])
            out.append(r)
    out.append({"arch": "rwkv6-3b", "shape": "decode_32k", "swan": False,
                "status": "skipped", "multi_pod": False})
    out.append({"arch": "jamba-1.5-large-398b", "shape": "train_4k",
                "swan": False, "status": "error", "multi_pod": False})
    assert cfg.name == jcfg.name
    return out


def test_report_renders_the_reference_rows(tmp_path):
    recs = _records()
    assert report.roofline_table(recs) == ref_report.roofline_table(recs)
    assert report.summary_stats(recs) == ref_report.summary_stats(recs)
    for i, r in enumerate(recs):
        (tmp_path / f"{i:02d}.json").write_text(json.dumps(r))
    assert report.load_records(str(tmp_path)) == \
        ref_report.load_records(str(tmp_path))


def test_report_adds_the_measured_columns(capsys, tmp_path):
    cfg = get_config("llama3-8b")
    rec = _record(3e13, 2e10, 0.0, n_dev=1, shape="decode_32k")
    rec["roofline"] = roofline.roofline_report(rec, cfg, SHAPES["decode_32k"])
    rec["measured"] = {"step_ms": 20.0,
                       "device": "NVIDIA H100 80GB HBM3, 700.00 W"}
    table = report.roofline_table([rec])
    share = rec["roofline"]["model_flops"] / (20e-3 * roofline.PEAK_FLOPS)
    assert f"{share:.2%}" in table and "700.00 W" in table
    assert report.measured_share(rec) == pytest.approx(share)
    (tmp_path / "a.json").write_text(json.dumps(rec))
    assert report.main([str(tmp_path)]) == 0
    assert "20.000" in capsys.readouterr().out
