"""The port's kernel microbenchmark and roofline on the CPU: the smoke run
writes its artifact with the reference bench's row names, and every
roofline function equals the reference's at the same arguments — except
``flash_kernel_bytes`` at Kv > 1, where the reference counts the k/v bytes
of one kv head and the port those of all of them.

The reference bench itself is not run (its interpret-mode kernels are
slow); its smoke row names are read off ``benchmarks/bench_kernels.py``:
the roofline rows of ``_decode_rooflines`` (k 8, page buckets 2 and 4),
``_chunk_roofline`` (S 64, k 8) and ``_flash_roofline`` (Sq 128), and the
rows of ``_legacy_paths``."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import roofline as j_rl  # noqa: E402
from repro_torch.analysis import roofline as rl  # noqa: E402
from repro_torch.benchmarks import bench_kernels  # noqa: E402

REF_ROOFLINE = ["swan_decode_slab_k8", "swan_decode_paged_k8_pg2",
                "swan_decode_paged_k8_pg4", "swan_chunk_stats_S64_k8",
                "flash_prefill_Sq128"]
REF_LEGACY = ["swan_decode_xla_ref", "flash_prefill_xla_blocked",
              "swan_prune_pallas_interpret", "swan_prune_xla_ref"]
# the port's own rows: its paged chunk kernel and its prune kernel get a
# roofline row (the reference times neither against a bound)
PORT_ONLY = ["swan_chunk_stats_paged_S64_k8", "swan_prune_S128_k8"]


def _legacy_name(ref_name: str) -> str:
    if ref_name == "swan_prune_pallas_interpret":
        return "swan_prune_kernel"
    return ref_name.replace("xla", "torch")


def test_smoke_bench_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path))
    bench_kernels.run(smoke=True, device="cpu")
    out = json.loads((tmp_path / "BENCH_kernels_torch.json").read_text())
    assert out["ok"] is True and out["device"] == "cpu"
    assert out["torch_version"] == torch.__version__
    roof = [r["name"] for r in out["extra"]["roofline"]]
    assert sorted(roof) == sorted(REF_ROOFLINE + PORT_ONLY)
    assert [r["name"] for r in out["rows"]] == (
        [f"roofline_{n}" for n in roof] + [_legacy_name(n) for n in REF_LEGACY])
    for r in out["extra"]["roofline"]:
        assert r["floor_us"] > 0 and r["us_per_call"] > 0
        assert 0 < r["achieved_fraction"] < float("inf")
    assert [g["name"] for g in out["gates"]] == ["kernels_roofline_fraction"]
    assert all(g["passed"] for g in out["gates"])


def test_bench_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_kernels.run(smoke=True)


DEC = dict(B=2, Kv=2, G=2, dh=16, S=128, k_max=8, buffer=16)


@pytest.mark.parametrize("quantized", [False, True])
def test_byte_models_equal_the_reference_at_f32(quantized):
    assert rl._sparse_side_bytes(2, 128, 8, quantized) == \
        j_rl._sparse_side_bytes(2, 128, 8, quantized)
    assert rl.swan_decode_kernel_bytes(**DEC, quantized=quantized) == \
        j_rl.swan_decode_kernel_bytes(**DEC, quantized=quantized)
    chunk = dict(B=2, Kv=2, Q=8, dh=16, S=64, k_max=8, quantized=quantized)
    assert rl.swan_chunk_kernel_bytes(**chunk) == \
        j_rl.swan_chunk_kernel_bytes(**chunk)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_models_against_the_reference(causal):
    shape = dict(B=2, H=8, Sq=128, Sk=256, dh=32)
    assert rl.flash_kernel_flops(**shape, causal=causal) == \
        j_rl.flash_kernel_flops(**shape, causal=causal)
    for db in (2, 4):
        ref = j_rl.flash_kernel_bytes(**shape, dtype_bytes=db)
        assert rl.flash_kernel_bytes(**shape, Kv=1, dtype_bytes=db) == ref
        # the reference counts k and v of one kv head (roofline.py:107):
        # with Kv heads the port adds the other Kv - 1 heads' k/v bytes
        got = rl.flash_kernel_bytes(**shape, Kv=4, dtype_bytes=db)
        assert got - ref == 2 * 2 * (4 - 1) * 256 * 32 * db


def test_value_widths_and_prune_model():
    bf16 = rl.swan_decode_kernel_bytes(**DEC, quantized=False, val_bytes=2,
                                       act_bytes=2)
    f32 = rl.swan_decode_kernel_bytes(**DEC, quantized=False)
    B, Kv, S, k, b, G, dh = 2, 2, 128, 8, 16, 2, 16
    assert f32 - bf16 == 2 * (2 * B * Kv * S * k + 2 * B * Kv * b * dh
                              + 2 * B * Kv * G * dh)
    # the full-width prune row: 29.9 MB, 2.1e9 operations
    nb = rl.swan_prune_kernel_bytes(B=4, Kv=8, S=2048, dh=128, k_max=64,
                                    x_bytes=2)
    assert nb == 4 * 8 * 2048 * (128 * 2 + 64 * 3) + 8 * 128 * 128 * 4
    assert rl.swan_prune_kernel_flops(B=4, Kv=8, S=2048, dh=128) == \
        2.0 * 4 * 8 * 2048 * 128 * 128


def test_roofline_row_uses_the_h100_constants():
    row = rl.roofline_row("x", 10.0, 3_350_000, flops=0.0, k=8)
    ref = j_rl.roofline_row("x", 10.0, 3_350_000, flops=0.0, k=8)
    assert row.keys() == ref.keys()
    assert row["floor_us"] == pytest.approx(1.0)      # 3.35 MB at 3.35 TB/s
    assert row["achieved_fraction"] == pytest.approx(0.1)
    assert row["bound"] == ref["bound"] == "memory"
    comp = rl.roofline_row("y", 1.0, 0, flops=989e6)
    assert comp["bound"] == "compute" and comp["floor_us"] == pytest.approx(1.0)
    assert (rl.PEAK_FLOPS, rl.HBM_BW) == (989e12, 3.35e12)
