"""swanlint for the port (``repro_torch.analysis.lint``) against the
reference's (``repro.analysis.lint``): each Layer 1 rule fires on a seeded
violation written in torch, stays quiet on its negative twin, and agrees
line for line with the reference rule on the reference's own snippet;
suppressions need a justification; fingerprints ignore line numbers; the
port's tree (``src/repro_torch/``, ``chip_smoke.py``,
``examples/torch_*.py``) lints clean, a seeded ``.item()`` on the engine's
``step()`` path is flagged (and fails the CLI), and the real fetch points
are not."""
import json
import os
import shutil
import textwrap

import pytest

from repro.analysis.lint.__main__ import main as ref_lint_main
from repro.analysis.lint.rules import lint_paths as ref_lint_paths
from repro.analysis.lint.rules import lint_source as ref_lint_source
from repro_torch.analysis.lint import (DEFAULT_BASELINE, DEFAULT_SCAN, RULES,
                                       collect_files, make_report,
                                       new_findings, run_lint)
from repro_torch.analysis.lint.__main__ import main as lint_main
from repro_torch.analysis.lint.rules import (HOST_FETCH_ALLOWLIST,
                                             lint_paths, lint_source)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE = "src/repro_torch/runtime/serve_engine.py"


def _lint(src, rel="src/repro_torch/runtime/engine.py"):
    return lint_source(textwrap.dedent(src), rel)


def _ref(src, rel="src/repro/runtime/engine.py"):
    return ref_lint_source(textwrap.dedent(src), rel)


def _active(findings, rule=None):
    return [f for f in findings
            if not f.suppressed and (rule is None or f.rule == rule)]


def _lines(findings, rule):
    return {f.line for f in _active(findings, rule)}


# ---------------------------------------------------------------------------
# SWAN101 — the port's import floor
# ---------------------------------------------------------------------------

IMPORT_SRC = """
    import jax
    import jaxlib.xla_client
    from repro.configs import get_config
    from benchmarks.common import emit

    def wire(f):
        return jax.jit(f)
"""


def test_imports_flag_jax_and_the_reference():
    hits = _active(_lint(IMPORT_SRC, rel="src/repro_torch/models/x.py"),
                   "SWAN101")
    assert {f.line for f in hits} == {2, 3, 4, 5}
    assert any("'repro.configs'" in f.message for f in hits)
    # the same rule guards the chip smoke script and the port's examples
    for rel in ("chip_smoke.py", "examples/torch_quickstart.py"):
        assert len(_active(_lint(IMPORT_SRC, rel=rel), "SWAN101")) == 4


def test_imports_allow_the_port_and_relative_imports():
    ok = """
        import torch
        import repro_torch
        from repro_torch.configs import get_config
        from . import ops
        from .ref import swan_decode_reference
        import reprolib_unrelated
    """
    assert not _active(_lint(ok, rel="src/repro_torch/kernels/x.py"),
                       "SWAN101")


# ---------------------------------------------------------------------------
# SWAN102 — host sync on the serve hot path
# ---------------------------------------------------------------------------

# the reference test's snippet and its torch twin, line for line
HOT_SRC_REF = """
    import jax
    import numpy as np

    class Eng:
        def __init__(self):
            self._decode = jax.jit(lambda x: x)

        def step(self):
            logits = self._decode(1)
            x = float(logits)                     # tainted conversion
            self._decode(1).block_until_ready()   # sync primitive
            return self._fetch(logits)

        def _fetch(self, logits):
            return np.asarray(logits)             # taint crosses the call

        def _lane_tokens(self, logits):
            return np.asarray(logits)             # designed fetch point

        def offline(self, logits):
            return float(logits)                  # not reachable from step
"""
HOT_SRC = """
    import torch
    import numpy as np

    class Eng:
        def __init__(self):
            self._graphs = None

        def step(self):
            logits = self._decode_call(1, 2, 3, None)
            x = float(logits)                     # tainted conversion
            self._graphs.run("decode", 1, None, [], list).item()
            return self._fetch(logits)

        def _fetch(self, logits):
            return np.asarray(logits)             # taint crosses the call

        def _lane_tokens(self, logits):
            return np.asarray(logits)             # designed fetch point

        def offline(self, logits):
            return float(logits)                  # not reachable from step
"""


def test_host_sync_flags_reachable_syncs_only():
    hits = _active(_lint(HOT_SRC), "SWAN102")
    assert len(hits) == 3, hits
    assert _lines(_lint(HOT_SRC), "SWAN102") == {11, 12, 16}
    assert _lines(_ref(HOT_SRC_REF), "SWAN102") == {11, 12, 16}


@pytest.mark.parametrize("call", ["out.tolist()", "out.cpu()",
                                  "out.numpy()", "torch.cuda.synchronize()",
                                  "self.event.synchronize()",
                                  "torch.cuda.current_stream().synchronize()"])
def test_host_sync_primitives_always_flagged(call):
    src = f"""
        import torch

        class Eng:
            def step(self):
                out = self._chunk_call(1, 2, 3, 4, 5, None, None)
                {call}
    """
    hits = _active(_lint(src), "SWAN102")
    assert len(hits) == 1 and hits[0].line == 7


def test_host_sync_untainted_conversion_ok():
    src = """
        import numpy as np

        class Eng:
            def __init__(self):
                self.slot_pos = np.zeros((4,), np.int32)

            def step(self):
                i = int(self.slot_pos[0])     # host numpy, never tainted
                self._decode_call(i, i, i, None)
    """
    assert not _active(_lint(src), "SWAN102")


def test_host_sync_scoped_to_runtime():
    assert not _active(_lint(HOT_SRC, rel="src/repro_torch/launch/serve.py"),
                       "SWAN102")
    assert not _active(_ref(HOT_SRC_REF, rel="src/repro/launch/serve.py"),
                       "SWAN102")


def test_lockstep_generate_is_a_root():
    src = """
        class Session:
            def decode(self, tok):
                return self._graphs.run("decode", 1, None, [tok], list)

            def generate(self, tok, n):
                for _ in range(n):
                    tok = self.decode(tok).argmax(-1)
                    n_done = int(tok[0])          # tainted: blocks
                return tok
    """
    assert _lines(_lint(src), "SWAN102") == {9}


def _engine_src():
    with open(os.path.join(REPO, ENGINE), encoding="utf-8") as fh:
        return fh.read()


def test_seeded_item_on_the_step_path_is_flagged():
    src = _engine_src()
    seeded = src.replace(
        "    def _maybe_retire(self, slot: int) -> None:\n"
        "        s = self.slots[slot]\n",
        "    def _maybe_retire(self, slot: int) -> None:\n"
        "        s = self.slots[slot]\n"
        "        self._fetch_bufs[0].sum().item()\n", 1)
    assert seeded != src
    hits = _active(lint_source(seeded, ENGINE), "SWAN102")
    assert len(hits) == 1 and "ServeEngine._maybe_retire" in hits[0].message
    assert not _active(lint_source(src, ENGINE))


def test_real_fetch_points_are_not_flagged():
    """The engine's designed fetch points sync (``event.synchronize()``,
    ``.tolist()``, ``.cpu()``) and are allowlisted; the same calls moved
    into a non-allowlisted hot function are flagged."""
    src = _engine_src()
    for name in HOST_FETCH_ALLOWLIST:
        assert f"def {name}(" in src
    assert "pending.event.synchronize()" in src and ".tolist()" in src
    renamed = src.replace("_resolve_tokens", "_resolve_tokens_moved")
    hits = _active(lint_source(renamed, ENGINE), "SWAN102")
    assert {h.snippet for h in hits} == {
        "pending.event.synchronize()", "greedy = pending.greedy.tolist()",
        "return [int(greedy[lane]) if req.temperature <= 0.0"}


def test_cli_fails_on_a_seeded_host_sync(tmp_path, capsys):
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(REPO, "src", "repro_torch"),
                    root / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert lint_main(["--root", str(root)]) == 0
    eng = root / ENGINE
    eng.write_text(eng.read_text().replace(
        "        self.step_count += 1\n        self._sample_gauges()",
        "        self.step_count += 1\n        self.next_tok.sum().item()\n"
        "        self._sample_gauges()", 1))
    out = tmp_path / "report.json"
    assert lint_main(["--root", str(root), "--check", "--json",
                      str(out)]) == 1
    assert "SWAN102" in capsys.readouterr().err
    assert out.exists()


# ---------------------------------------------------------------------------
# SWAN103 — shape bucketing
# ---------------------------------------------------------------------------

BUCKET_SRC_REF = """
    import numpy as np

    def build_decode(n):
        return np.zeros((4, 48), np.int32)

    def init_params(n):
        return np.zeros((4, 48), np.float32)   # not a dispatch function
"""
BUCKET_SRC = """
    import torch

    def build_decode(x, n):
        return torch.zeros(4, 48), x.expand(4, 24, -1)

    def init_params(n):
        return torch.zeros((4, 48))              # not a dispatch function
"""


def test_bucketing_flags_non_pow2_in_dispatch_functions():
    hits = _active(_lint(BUCKET_SRC), "SWAN103")
    assert {f.message.split()[2] for f in hits} == {"48", "24"}
    assert _lines(_lint(BUCKET_SRC_REF), "SWAN103") == \
        _lines(_ref(BUCKET_SRC_REF), "SWAN103") == {5}


@pytest.mark.parametrize("call", ["torch.full((4, 48), -1)",
                                  "torch.empty((3, 8))",
                                  "torch.broadcast_to(x, (8, 12))",
                                  "x.broadcast_to((6,))",
                                  "np.ones((5,), np.int64)"])
def test_bucketing_each_constructor(call):
    src = f"import numpy as np\nimport torch\ndef prefill_chunk(x):\n" \
          f"    return {call}\n"
    assert len(_active(_lint(src), "SWAN103")) == 1


def test_bucketing_pow2_and_scope_negatives():
    ok = """
        import torch

        def build_decode(x, n):
            return (torch.zeros((4, 64), dtype=torch.int32),
                    torch.full((8,), 3), x.expand(-1, 16), torch.empty(n, 1))
    """
    assert not _active(_lint(ok), "SWAN103")
    assert not _active(_lint(BUCKET_SRC, rel="src/repro_torch/optim/adamw.py"),
                       "SWAN103")


# ---------------------------------------------------------------------------
# SWAN104 — spec completeness (the port's sharding/serve_specs.py)
# ---------------------------------------------------------------------------

SPECS = "src/repro_torch/sharding/serve_specs.py"
CACHE = "src/repro_torch/core/hybrid_cache.py"


def _spec_fixture(tmp_path, cache_src, ref=False):
    """SWAN104 over the real serve_specs.py (KNOWN_LEAF_NAMES) and a
    seeded cache module, by the port's rule or (``ref``) the
    reference's on the same snippet."""
    pkg, lint = ("repro", ref_lint_paths) if ref else ("repro_torch",
                                                        lint_paths)
    for rel in (f"src/{pkg}/sharding/serve_specs.py",
                f"src/{pkg}/core/hybrid_cache.py"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(os.path.join(REPO, "src", pkg, "sharding", "serve_specs.py"),
                tmp_path / f"src/{pkg}/sharding/serve_specs.py")
    (tmp_path / f"src/{pkg}/core/hybrid_cache.py").write_text(
        textwrap.dedent(cache_src))
    return lint(str(tmp_path), [f"src/{pkg}/sharding/serve_specs.py",
                                f"src/{pkg}/core/hybrid_cache.py"])


ROGUE_SRC = """
    import {m}

    def init_cache(L):
        d = {{"k": {m}.zeros((L,)), "rogue": {m}.zeros((L,))}}
        d["late"] = {m}.zeros((L,))
        return d
"""


def test_spec_completeness_keeps_its_id_and_reports_skip(tmp_path):
    """SWAN104 keeps its ID and now runs (it reported "skip" while the
    port had no serve specs, so the report lists no skipped rules any
    more), and a seeded unknown leaf is reported where the reference's
    rule reports it."""
    assert "SWAN104" in RULES
    fs = _spec_fixture(tmp_path, ROGUE_SRC.format(m="torch"))
    hits = _active(fs, "SWAN104")
    assert {f.message.split("'")[1] for f in hits} == {"rogue", "late"}
    ref = _active(_spec_fixture(tmp_path, ROGUE_SRC.format(m="jnp"),
                                ref=True), "SWAN104")
    assert {(f.line, f.message.split("'")[1]) for f in hits} == \
        {(f.line, f.message.split("'")[1]) for f in ref}
    assert "skipped_rules" not in make_report(fs)
    # a suppression naming it is well formed
    assert not _lint("x = 1  # swanlint: disable=SWAN104 -- host only\n")


def test_spec_completeness_reads_the_port_idioms(tmp_path):
    """The port's initialisers: ``packed_side``, ``init_*caches`` and a
    module's own ``_zeros`` wrapper build leaves; a known leaf, a nested
    dict and a non-constructor call do not report."""
    fs = _spec_fixture(tmp_path, """
        import torch

        def packed_side(rows):
            d = {"vals": _zeros(rows), "bogus": _zeros(rows)}
            return d

        def init_paged_caches(L):
            return {"pool": {"k": side(L)}, "buf_pos": torch.full((L,), -1),
                    "extra": torch.empty((L,))}

        def not_an_init(L):
            return {"hidden": torch.zeros((L,))}
    """)
    assert {f.message.split("'")[1] for f in _active(fs, "SWAN104")} == \
        {"bogus", "extra"}


def test_spec_completeness_suppressible(tmp_path):
    fs = _spec_fixture(tmp_path, """
        import torch

        def init_cache(L):
            return {
                # swanlint: disable=SWAN104 -- host-only scratch, never
                # crosses a mesh
                "rogue": torch.zeros((L,)),
            }
    """)
    hits = [f for f in fs if f.rule == "SWAN104"]
    assert hits and all(f.suppressed for f in hits)


def test_port_state_leaves_are_all_known():
    """Every leaf the port's initialisers build is in KNOWN_LEAF_NAMES
    (and the rule found them: the set is not empty)."""
    import ast
    from repro_torch.analysis.lint.rules import (SPEC_STATE_MODULES,
                                                 extract_known_leaf_names,
                                                 extract_state_leaves)
    with open(os.path.join(REPO, SPECS), encoding="utf-8") as fh:
        known = extract_known_leaf_names(ast.parse(fh.read()))
    found = set()
    for mod in SPEC_STATE_MODULES:
        with open(os.path.join(REPO, "src/repro_torch", mod),
                  encoding="utf-8") as fh:
            found |= {n for n, _ in extract_state_leaves(ast.parse(fh.read()))}
    assert found == set(known)


# ---------------------------------------------------------------------------
# SWAN105 — obs hygiene
# ---------------------------------------------------------------------------

OBS_SRC = """
    _step_counters = {}

    limits = {}     # not metric-named: fine
"""


def test_obs_flags_module_level_metric_dicts():
    hits = _active(_lint(OBS_SRC), "SWAN105")
    assert len(hits) == 1 and "_step_counters" in hits[0].message
    assert _lines(_ref(OBS_SRC), "SWAN105") == {2}


def test_obs_allows_registry_module():
    assert not _active(_lint(OBS_SRC, rel="src/repro_torch/obs/metrics.py"),
                       "SWAN105")


# ---------------------------------------------------------------------------
# Suppressions
# ---------------------------------------------------------------------------

def test_justified_suppression_covers_whole_statement():
    src = """
        class Eng:
            def step(self):
                out = self._decode_call(1, 2, 3, None)
                # swanlint: disable=SWAN102 -- test fixture: measured sync
                return [float(out),
                        float(out)]
    """
    hits = [f for f in _lint(src) if f.rule == "SWAN102"]
    assert len(hits) == 2 and all(f.suppressed for f in hits)
    assert all("measured sync" in f.justification for f in hits)


def test_unjustified_suppression_is_a_finding_and_does_not_suppress():
    src = """
        class Eng:
            def step(self):
                out = self._decode_call(1, 2, 3, None)
                return float(out)  # swanlint: disable=SWAN102
    """
    fs = _lint(src)
    assert _active(fs, "SWAN100")
    assert _active(fs, "SWAN102")              # NOT suppressed


def test_unknown_rule_id_flagged():
    src = "x = 1  # swanlint: disable=SWAN999 -- nope\n"
    assert _active(lint_source(src, "src/repro_torch/x.py"), "SWAN100")
    assert _active(ref_lint_source(src, "src/repro/x.py"), "SWAN100")


# ---------------------------------------------------------------------------
# The port's tree
# ---------------------------------------------------------------------------

def test_port_tree_lints_clean():
    files = collect_files(REPO, DEFAULT_SCAN)
    assert "chip_smoke.py" in files and ENGINE in files
    assert any(f.startswith("examples/torch_") for f in files)
    assert not any(f.startswith("src/repro/") for f in files)
    findings = run_lint(REPO)
    assert not _active(findings), [f.to_json() for f in _active(findings)]
    assert new_findings(findings, None) == []
    assert lint_main(["--root", REPO, "--check"]) == 0


def test_report_counts_and_fingerprint_stability():
    findings = run_lint(REPO)
    rep = make_report(findings)
    assert rep["counts"]["total"] == len(findings)
    assert rep["counts"]["active"] == 0
    src = ("class E:\n    def step(self):\n"
           "        return float(self._decode_call(1, 2, 3, None))\n")
    f1 = _active(lint_source(src, "src/repro_torch/runtime/x.py"), "SWAN102")
    shifted = "# pad\n" + src
    f2 = _active(lint_source(shifted, "src/repro_torch/runtime/x.py"),
                 "SWAN102")
    assert f1[0].fingerprint == f2[0].fingerprint
    assert f1[0].line != f2[0].line
    # a baseline holding the finding accepts it
    assert new_findings(f2, {"findings": [f1[0].to_json()]}) == []


# ---------------------------------------------------------------------------
# The CLI's flags against the reference CLI's
# ---------------------------------------------------------------------------

SEEDED = "_step_counters = {}\n"        # SWAN105 in either package


def _seeded_roots(tmp_path):
    """Two repo roots, each with one seeded SWAN105 finding: one in the
    reference's tree, one in the port's."""
    roots = {}
    for pkg in ("repro", "repro_torch"):
        root = tmp_path / pkg
        mod = root / "src" / pkg / "runtime" / "seeded.py"
        mod.parent.mkdir(parents=True)
        mod.write_text(SEEDED)
        roots[pkg] = str(root)
    return roots


def _stub_audit(monkeypatch, status):
    """Both packages' ``run_audit`` replaced by one check of ``status``
    (the reference's builds the JAX engine matrix: minutes on the CPU)."""
    import repro.analysis.lint.audit as ref_audit
    import repro_torch.analysis.lint.audit as port_audit
    for mod in (ref_audit, port_audit):
        monkeypatch.setattr(mod, "run_audit",
                            lambda *a, _m=mod, **k: [
                                _m.AuditCheck("stub/check", status, "")])


FLAG_SETS = {"none": [], "check": ["--check"], "report": ["--report"],
             "check-report": ["--check", "--report"],
             "write-baseline": ["--write-baseline"],
             "audit-smoke": ["--audit-smoke"],
             "check-audit-smoke": ["--check", "--audit-smoke"]}


@pytest.mark.parametrize("flags", list(FLAG_SETS))
def test_cli_exit_codes_match_the_reference(flags, tmp_path, monkeypatch):
    """On one seeded finding each flag set exits as the reference's CLI
    does: 1 only under ``--check``; a report and a baseline are written
    where asked."""
    _stub_audit(monkeypatch, "pass")
    roots = _seeded_roots(tmp_path)
    rcs = {}
    for pkg, main in (("repro", ref_lint_main), ("repro_torch", lint_main)):
        argv = ["--root", roots[pkg]]
        for f in FLAG_SETS[flags]:
            argv += [f, os.path.join(roots[pkg], "out", "report.json")] \
                if f == "--report" else [f]
        rcs[pkg] = main(argv)
        if "--report" in argv:
            with open(argv[argv.index("--report") + 1]) as fh:
                rep = json.load(fh)
            assert rep["counts"]["active"] == 1
            assert [f["rule"] for f in rep["findings"]] == ["SWAN105"]
    assert rcs["repro_torch"] == rcs["repro"] == \
        (1 if "--check" in FLAG_SETS[flags] else 0)


def test_cli_write_baseline_accepts_the_finding(tmp_path, monkeypatch,
                                                capsys):
    """``--write-baseline`` then ``--check`` passes in both CLIs; the
    port's baseline is its own file and the reference's is untouched."""
    roots = _seeded_roots(tmp_path)
    ref_base = os.path.join(roots["repro_torch"], "bench_out",
                            "LINT_BASELINE.json")
    os.makedirs(os.path.dirname(ref_base))
    with open(ref_base, "w") as fh:
        fh.write("{}\n")
    for pkg, main in (("repro", ref_lint_main), ("repro_torch", lint_main)):
        assert main(["--root", roots[pkg], "--write-baseline"]) == 0
        assert main(["--root", roots[pkg], "--check"]) == 0
    port_base = os.path.join(roots["repro_torch"], DEFAULT_BASELINE)
    assert DEFAULT_BASELINE != os.path.join("bench_out", "LINT_BASELINE.json")
    with open(port_base) as fh:
        assert [f["rule"] for f in json.load(fh)["findings"]] == ["SWAN105"]
    with open(ref_base) as fh:
        assert fh.read() == "{}\n"
    assert "baseline written: " + port_base in capsys.readouterr().out
    # a new finding on top of the baseline fails the gate again
    mod = os.path.join(roots["repro_torch"], "src", "repro_torch", "runtime",
                       "seeded.py")
    with open(mod, "a") as fh:
        fh.write("_more_gauges = {}\n")
    assert lint_main(["--root", roots["repro_torch"], "--check"]) == 1


@pytest.mark.parametrize("check", [False, True])
def test_cli_audit_failure_gates_only_under_check(check, tmp_path,
                                                  monkeypatch):
    """A failing audit check on a clean tree: exit 1 under ``--check`` and
    0 without it, in both CLIs."""
    _stub_audit(monkeypatch, "fail")
    argv = ["--audit-smoke"] + (["--check"] if check else [])
    for main in (ref_lint_main, lint_main):
        assert main(["--root", str(tmp_path)] + argv) == int(check)


def test_cli_audit_smoke_runs_the_serve_auditor_on_the_cpu(tmp_path,
                                                            capsys):
    """The real ``--audit-smoke`` of the port on its clean tree: the CPU
    audit passes (its graph and kernel checks skip) and the gate holds."""
    out = tmp_path / "report.json"
    assert lint_main(["--root", REPO, "--check", "--audit-smoke",
                      "--report", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["counts"]["audit_failures"] == 0
    assert {c["status"] for c in rep["audit"]} == {"pass", "skip"}
    assert "audit failure(s)" in capsys.readouterr().out
