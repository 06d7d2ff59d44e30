"""The port's serve auditor (``repro_torch.analysis.lint.audit``): each
check helper fails on a seeded fault and passes its clean twin (the
reference's Layer 2 cases, over ``StepCosts`` and a graph's node census
instead of HLO text), the graph census parses CUDA's terse DOT (the
form ``GraphSet.dot`` prints), the prechecks agree with the reference's
on seeded shapes, one gate closes the kernels for every reader, and
``run_audit(device="cpu")`` on the llama3-8b smoke config reports no
failure, its graph and kernel checks skipping with a reason."""
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

from repro.analysis.lint.audit import \
    kernel_precheck_checks as ref_precheck_checks  # noqa: E402
from repro.configs import SwanConfig as JSwan  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro_torch.analysis.cost import OpCost, StepCosts  # noqa: E402
from repro_torch.analysis.lint.audit import (AuditCheck,  # noqa: E402
                                             GraphCensus, capture_check,
                                             collective_check, count_check,
                                             kernel_precheck_checks,
                                             launch_check,
                                             logical_view_check,
                                             parse_graph_dot, run_audit,
                                             transfer_check)
from repro_torch.configs import (SwanConfig, get_config,  # noqa: E402
                                 get_smoke_config)

# a node of each kind, in CUDA's terse DOT (flags 0)
TERSE_DOT = """digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_0"[style="bold" shape="octagon" label="0
_Z18swan_decode_kernelIfLi4EEv4ArgsIT_T0_EPKS0_PKiS7_Pf
"];

"graph_1_node_1"[style="bold" shape="octagon" label="1
_Z24swan_decode_merge_kernelIfEvPKfPKiPT_iiii
"];

"graph_1_node_2"[style="solid" shape="trapezium"label="2
MEMCPY
(HtoD,16)
"];

"graph_1_node_3"[style="bold" shape="octagon" label="3
ncclDevKernel_AllReduce_Sum_f32_RING_LL
"];

"graph_1_node_4"[style="solid" shape="trapezium"label="4
MEMCPY
(DtoH,4096)
"];

"graph_1_node_5"[style="solid" shape="rectangle" label="5
HOST
"];

"graph_1_node_0" -> "graph_1_node_1";
}
}
"""# a graph without host traffic or NCCL kernel, terse
CLEAN_DOT = """digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_0"[style="bold" shape="octagon" label="0
_Z18swan_chunk_mma_kernelILi64EEv4Args
"];

"graph_1_node_1"[style="solid" shape="trapezium"label="1
MEMCPY
(HtoD,64)
"];

"graph_1_node_2"[style="solid" shape="invtrapezium"label="2
MEMSET
"];

"graph_1_node_0" -> "graph_1_node_1";
}
}
"""


def _costs(*ops):
    c = StepCosts()
    for o in ops:
        c.add(o)
    return c


def test_parse_graph_dot_terse():
    t = parse_graph_dot(TERSE_DOT)
    assert t.count("swan_decode_kernel") == 1
    assert t.count("swan_decode_merge_kernel") == 1
    assert sum(t.kernels.values()) == 3 and t.nccl == 1
    assert t.memcpy == {"HtoD": 1, "DtoH": 1}
    assert t.host == 1 and not t.other
    assert parse_graph_dot(CLEAN_DOT) == GraphCensus(
        kernels=Counter({"_Z18swan_chunk_mma_kernelILi64EEv4Args": 1}),
        memcpy=Counter({"HtoD": 1}), other=Counter({"MEMSET": 1}))


def test_transfer_check_fails_on_seeded_host_traffic():
    seeded = _costs(OpCost("mm", "matmul", 8.0, 64.0),
                    OpCost("_local_scalar_dense", "transfer", 0.0, 4.0),
                    OpCost("copy_", "transfer", 0.0, 512.0))
    c = transfer_check(seeded, "seeded")
    assert c.status == "fail" and "2 host transfer" in c.detail
    assert transfer_check(_costs(OpCost("mm", "matmul", 8.0, 64.0)),
                          "clean").status == "pass"
    g = transfer_check(parse_graph_dot(TERSE_DOT), "graph")
    assert g.status == "fail" and "device-to-host" in g.detail \
        and "host node" in g.detail
    clean = GraphCensus(memcpy={"HtoD": 3})
    assert transfer_check(clean, "graph").status == "pass"


def test_collective_check_fails_on_undeclared_collective():
    seeded = _costs(OpCost("allreduce_", "collective", 0.0, 4096.0))
    assert seeded.per_collective == {"all-reduce": 4096.0}
    assert collective_check(seeded, "seeded").status == "fail"
    assert collective_check(StepCosts(), "clean").status == "pass"
    assert collective_check(seeded, "ok",
                            allowed=("all-reduce",)).status == "pass"
    assert collective_check(parse_graph_dot(TERSE_DOT),
                            "graph").status == "fail"
    assert collective_check(parse_graph_dot(CLEAN_DOT),
                            "graph").status == "pass"


def test_count_check_bounds():
    assert count_check("x", 5, 3).status == "fail"
    assert count_check("x", 3, 3).status == "pass"
    assert count_check("x", -1, 3).status == "skip"


def test_capture_and_launch_checks():
    assert capture_check("x", 3, 3).status == "pass"
    assert capture_check("x", 3, 4).status == "fail"
    disp = {"prefill": 0, "chunk": 3, "decode": 10}
    ok = {"swan_decode": 320, "swan_chunk_stats": 96, "swan_decode_paged": 0,
          "swan_chunk_stats_paged": 0, "flash_attention": 0, "swan_prune": 0}
    assert launch_check("slab", ok, disp, "slab", 32).status == "pass"
    assert launch_check("slab", dict(ok, swan_decode=319), disp, "slab",
                        32).status == "fail"
    assert launch_check("slab", dict(ok, swan_decode_paged=1), disp, "slab",
                        32).status == "fail"
    assert launch_check("paged", ok, disp, "paged", 32).status == "fail"


def _dot(symbols):
    """A terse DOT of kernel nodes, one per symbol."""
    nodes = "".join(f'"graph_1_node_{i}"[style="bold" shape="octagon" '
                    f'label="{i}\n_Z{len(s)}{s}v4Args\n"];\n\n'
                    for i, s in enumerate(symbols))
    return ("digraph dot {\nsubgraph cluster_1 {\nlabel=\"graph_1\" "
            f"graph[style=\"dashed\"];\n{nodes}}}\n}}\n")


class _FakeGraphs:
    """One decode and one chunk graph: their DOT node census and the
    wrapper launches tallied at capture."""

    def __init__(self, n_decode, n_chunk, decode_tally=None):
        self.dots = {
            "decode": _dot(["swan_decode_kernel",
                            "swan_decode_merge_kernel"] * n_decode),
            "chunk": _dot(["swan_chunk_mma_kernel"] * n_chunk)}
        self.tallies = {"decode": {"swan_decode": decode_tally or n_decode},
                        "chunk": {"swan_chunk_stats": n_chunk}}

    def keys(self, fam):
        return [(fam, 0)]

    def dot(self, fam, key):
        return self.dots[fam]

    def tally(self, fam, key):
        return self.tallies[fam]


class _FakeEngine:
    paged = False

    def __init__(self, cfg, graphs):
        self.cfg, self._graphs = cfg, graphs


def test_launch_and_graph_counts_at_two_decode_groups():
    """At G = 16 (llama3-405b) the decode kernels launch twice per layer
    (``swan_decode.g_plan``'s two groups of 8), the chunk kernels once:
    the counters expect exactly that and still fail on a missing or an
    extra launch."""
    from repro_torch.analysis.lint.audit import audit_graphs, decode_groups
    full = get_config("llama3-405b")
    g16 = get_smoke_config("llama3-405b").replace(n_heads=32, n_kv_heads=2)
    assert decode_groups(full) == decode_groups(g16) == 2
    assert decode_groups(get_config("llama3-8b")) == 1
    assert decode_groups(get_config("internvl2-1b")) == 1       # G = 7
    disp = {"prefill": 0, "chunk": 3, "decode": 10}
    ok = {"swan_decode": 2 * 2 * 10, "swan_chunk_stats": 2 * 3,
          "swan_decode_paged": 0, "swan_chunk_stats_paged": 0,
          "flash_attention": 0, "swan_prune": 0}
    assert launch_check("g16", ok, disp, "slab", 2, groups=2).status == "pass"
    for bad in (dict(ok, swan_decode=2 * 10), dict(ok, swan_decode=41),
                dict(ok, swan_decode=39), dict(ok, swan_chunk_stats=12)):
        assert launch_check("g16", bad, disp, "slab", 2,
                            groups=2).status == "fail", bad
    assert launch_check("g16", ok, disp, "slab", 2).status == "fail"
    # the graph census: 2 layers x 2 groups of split + merge nodes
    checks = audit_graphs(_FakeEngine(g16, _FakeGraphs(4, 2)), "g16", 2)
    assert {c.check: c.status for c in checks}[
        "graph-kernels/g16/decode"] == "pass"
    assert all(c.status == "pass" for c in checks), checks
    for graphs in (_FakeGraphs(2, 2), _FakeGraphs(5, 2),
                   _FakeGraphs(4, 2, decode_tally=2), _FakeGraphs(4, 4)):
        checks = audit_graphs(_FakeEngine(g16, graphs), "g16", 2)
        assert any(c.status == "fail" for c in checks)
    # G = 4: one group
    g4 = get_smoke_config("llama3-405b")
    assert all(c.status == "pass" for c in audit_graphs(
        _FakeEngine(g4, _FakeGraphs(2, 2)), "g4", 2))


def test_logical_view_check_trips_on_a_seeded_gather():
    view = 2 * 2 * 64 * 8
    kernel_path = _costs(OpCost("index", "other", 0.0, 64.0, 128),
                         OpCost("swan_decode_paged", "kernel", 1.0, 1.0))
    plain_path = _costs(OpCost("index", "other", 0.0, 64.0, view))
    assert logical_view_check(kernel_path, "k", view).status == "pass"
    assert logical_view_check(plain_path, "k", view).status == "fail"
    assert logical_view_check(plain_path, "ref", view,
                              expect_materialized=True).status == "pass"
    assert logical_view_check(kernel_path, "ref", view,
                              expect_materialized=True).status == "fail"
    # a large non-gather result (logits) never counts
    logits = _costs(OpCost("mm", "matmul", 1.0, 1.0, 10 * view))
    assert logical_view_check(logits, "k", view).status == "pass"


def test_kernel_precheck_fails_on_seeded_shapes():
    cfg = get_smoke_config("llama3-8b")
    bad = kernel_precheck_checks(cfg.replace(d_head=256),
                                 SwanConfig(k_max=300, buffer=4), 64,
                                 page_size=16, chunk_q=16)
    assert all(c.status == "fail" for c in bad)
    assert any("k_max=300" in c.detail for c in bad)
    gqa = kernel_precheck_checks(cfg.replace(n_kv_heads=3), None, 64)
    assert gqa[0].status == "skip"
    assert gqa[-1].status == "fail" and "Kv=3" in gqa[-1].detail


def test_kernel_precheck_checks_smoke_config():
    cfg = get_smoke_config("llama3-8b")
    mine = kernel_precheck_checks(cfg, SwanConfig(k_max=cfg.d_head, buffer=4),
                                  64, page_size=16, chunk_q=16)
    assert all(c.status == "pass" for c in mine), mine
    ref = ref_precheck_checks(j_smoke("llama3-8b"),
                              JSwan(k_max=cfg.d_head, buffer=4, mode="topk"),
                              64, page_size=16, chunk_q=16)
    # the same kernels pass at the same shapes (the budgets differ: VMEM
    # there, a Hopper block's shared memory here)
    assert all(c.status == "pass" for c in ref)
    assert len(mine) == len(ref)


def test_run_audit_on_the_cpu():
    checks = run_audit(device="cpu")
    assert all(isinstance(c, AuditCheck) for c in checks)
    bad = [c.to_json() for c in checks if c.status == "fail"]
    assert not bad, bad
    by = {c.check: c for c in checks}
    # the graph and kernel checks skip with their reason; they never pass
    for name in ("exec-count/slab", "warmup/paged", "graphs/slab",
                 "engine/slab-kernel", "engine/paged-kernel"):
        assert by[name].status == "skip" and by[name].detail
    assert "CUDA" in by["graphs/slab"].detail
    assert by["engine/paged-dp2"].status == "pass"
    # the dispatch bodies, the steps and the detector run for real
    for name in ("host-transfers/slab/decode", "host-transfers/paged/chunk",
                 "collectives/paged/decode", "host-sync/slab",
                 "host-sync/paged"):
        assert by[name].status == "pass"
    view = [c for c in checks if c.check.startswith("logical-view/paged")]
    assert view and view[0].status == "pass" and "materialises" in \
        view[0].detail


def test_plain_reads_closes_the_kernel_gate_for_every_reader():
    """``kernels.dispatch.plain_reads`` answers no for a cache on the card
    wherever the gate is read: the models and the engine import it."""
    from types import SimpleNamespace

    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer
    from repro_torch.runtime import serve_engine
    swan = SwanConfig(k_max=8, buffer=4, mode="topk")
    on_card = SimpleNamespace(shape=(2, 1, 16, 8), is_cuda=True)
    readers = (dispatch.kernel_supported, transformer.kernel_supported,
               serve_engine.kernel_supported)
    assert all(gate(swan, on_card) for gate in readers)
    with dispatch.plain_reads():
        assert not any(gate(swan, on_card) for gate in readers)
    assert all(gate(swan, on_card) for gate in readers)


def test_step_sync_check_catches_a_seeded_item(monkeypatch):
    """An ``.item()`` added to the engine's step path (outside the fetch
    points) fails the per-step host-sync census."""
    from repro_torch.analysis.lint import audit
    from repro_torch.runtime import serve_engine

    real = serve_engine.ServeEngine._sample_gauges

    def leaky(self):
        next(iter(serve_engine._leaves(self.state))).sum().item()
        return real(self)
    monkeypatch.setattr(serve_engine.ServeEngine, "_sample_gauges", leaky)
    checks = run_audit(device="cpu")
    sync = [c for c in checks if c.check.startswith("host-sync/")]
    assert sync and all(c.status == "fail" for c in sync)
    assert "outside the fetch points" in sync[0].detail
    assert audit.FETCH_POINTS == ("_resolve_tokens", "_sample")
