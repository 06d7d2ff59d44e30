"""The port's analytical models (paper Eq. 1 and 2, Appendix A.2, the
whole-model cache accounting) against ``repro.core.analytical`` on a grid,
and the three analytical benches' rows (Fig. 2a, Eq. 2, the memory
footprint) against the reference benches' rows for the port's archs."""
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.configs import SwanConfig as JSwan  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.core import analytical as ja  # noqa: E402
from repro_torch.configs import ARCH_IDS, SwanConfig, get_config  # noqa: E402
from repro_torch.core import analytical as ta  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
D_HEADS = (16, 64, 80, 128)
KS = (1, 8, 32, 64, 96, 127, 128)


def test_per_vector_functions_match_reference():
    for dh in D_HEADS:
        for bits8 in (False, True):
            assert ta.memory_breakeven_retention(dh, bits8) == \
                ja.memory_breakeven_retention(dh, bits8)
        for item in (1, 2, 4):
            assert ta.dense_vector_bytes(dh, item) == \
                ja.dense_vector_bytes(dh, item)
        for k in KS:
            for bits8 in (False, True):
                assert ta.sparse_vector_bytes(k, bits8) == \
                    ja.sparse_vector_bytes(k, bits8)
                assert ta.compression_ratio(k, dh, bits8) == \
                    ja.compression_ratio(k, dh, bits8)


def test_flop_models_match_reference():
    for dh in D_HEADS:
        for k in KS:
            for b in (0, 8, 128):
                assert ta.breakeven_length(dh, k, b) == \
                    ja.breakeven_length(dh, k, b)
                for L in (1, 100, 128, 129, 4096, 32768):
                    assert ta.flops_swan(L, dh, k, b) == \
                        ja.flops_swan(L, dh, k, b)
        for L in (1, 128, 32768):
            assert ta.flops_standard(L, dh) == ja.flops_standard(L, dh)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_cache_footprint_matches_reference(arch):
    for kw in (dict(k_max=64, buffer=128), dict(k_max=32, buffer=0),
               dict(k_max=128, buffer=8, quantize=True)):
        for batch, seq in ((1, 1), (4, 4096), (128, 32768)):
            got = ta.model_cache_footprint(get_config(arch), SwanConfig(**kw),
                                           batch, seq)
            want = ja.model_cache_footprint(j_config(arch), JSwan(**kw),
                                            batch, seq)
            assert (got.dense_bytes, got.swan_bytes) == \
                (want.dense_bytes, want.swan_bytes)
            if want.dense_bytes == 0:
                # no attention layer (rwkv6-3b): no saving to state, in
                # either package
                for fp in (got, want):
                    with pytest.raises(ZeroDivisionError):
                        fp.saving
            else:
                assert got.saving == want.saving


@pytest.mark.parametrize("name", ["fig2a_compression", "breakeven",
                                  "memory_footprint"])
def test_bench_rows_match_reference(name, tmp_path, monkeypatch):
    """Every row the port's bench emits equals the reference bench's row
    (name and derived; the memory footprint's for the port's archs), and
    every Eq. 2 row says match=yes."""
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path))
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import importlib
    ref_common = importlib.import_module("benchmarks.common")
    jbench = importlib.import_module(f"benchmarks.bench_{name}")
    tbench = importlib.import_module(f"repro_torch.benchmarks.bench_{name}")
    with ref_common.bench_record(name) as jrec:
        jbench._run()
    trec = tbench.run()
    want = [(r["name"], r["derived"]) for r in jrec.rows
            if name != "memory_footprint"
            or r["derived"].split("_")[0] in ARCH_IDS]
    got = [(r["name"], r["derived"]) for r in trec.rows]
    assert got == want and got
    assert (tmp_path / f"BENCH_{name}_torch.json").exists()
    if name == "breakeven":
        eq2 = [d for n, d in got if n == "eq2_breakeven"]
        assert len(eq2) == 6 and all(d.endswith("match=yes") for d in eq2)
        assert all(g["passed"] for g in trec.gates)
    if name == "memory_footprint":
        assert {d.split("_")[0] for _, d in got} == set(ARCH_IDS)
