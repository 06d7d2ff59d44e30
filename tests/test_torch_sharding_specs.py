"""The port's sharding specs (``repro_torch.sharding``) against the
reference's (``repro.sharding``): parameter specs of every full config on
fake 16 x 16 and 2 x 16 x 16 meshes (the port's tree built on the ``meta``
device, handed to both as leaf shapes; the tree itself held to the
reference's abstract tree), serve-state specs of every smoke config's
slab, int8 slab, paged, dense and recurrent states, the sanitizer's cases,
batch specs, the activation rules and completeness over every state the
engine builds."""
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import SwanConfig as JSwan
from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.models import get_model as j_get_model
from repro.sharding import serve_specs as jss
from repro.sharding import specs as jspecs
from repro.sharding.api import current_rules as j_current_rules
from repro_torch.configs import (ARCH_IDS, SwanConfig, get_config,
                                 get_smoke_config)
from repro_torch.models.registry import get_model, swan_applicable
from repro_torch.sharding import serve_specs as tss
from repro_torch.sharding import specs as tspecs
from repro_torch.sharding.api import (P, PartitionSpec, ShardingRules,
                                      current_rules, use_rules)
from repro_torch.tree import flatten_with_path


class Mesh2:
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")


class Mesh3:
    shape = {"pod": 2, "data": 16, "model": 16}
    axis_names = ("pod", "data", "model")


MESHES = {"16x16": Mesh2, "2x16x16": Mesh3}
META = torch.device("meta")


def _ref_by_path(tree):
    """{path: tuple(spec)} of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(getattr(k, "key", str(k)) for k in path): tuple(s)
            for path, s in flat}


def _mine_by_path(tree):
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{prefix}/{k}" if prefix else str(k))
        else:
            assert isinstance(t, PartitionSpec), (prefix, t)
            out[prefix] = tuple(t)
    walk(tree, "")
    return out


def test_arch_ids_equal_the_reference():
    assert ARCH_IDS == J_ARCH_IDS


def _as_jax_tree(tree):
    """The port's (meta) tree as the reference's abstract leaves."""
    if isinstance(tree, dict):
        return {k: _as_jax_tree(v) for k, v in tree.items()}
    return jax.ShapeDtypeStruct(tuple(tree.shape), "float32")


def _ref_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return ["/".join(k.key for k in path) for path, _ in flat]


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_params_pspecs_match_reference(arch):
    """Every leaf of the full config's tree (built on the meta device), by
    path, on both meshes: the reference's spec of the same leaf."""
    jcfg, tcfg = j_config(arch), get_config(arch)
    tparams = get_model(tcfg).init_params(tcfg, 0, META)
    jtree = _as_jax_tree(tparams)
    for mesh in MESHES.values():
        m = mesh()
        want = _ref_by_path(jspecs.params_pspecs(jtree, jcfg, m))
        assert _mine_by_path(tspecs.params_pspecs(tparams, tcfg, m)) == want


@pytest.mark.parametrize("arch", ["llama3-405b", "jamba-1.5-large-398b",
                                  "whisper-small"])
def test_meta_tree_is_the_reference_abstract_tree(arch):
    """The meta-device tree of a full config has the reference's leaves
    and shapes (``jax.eval_shape`` of its init)."""
    jcfg, tcfg = j_config(arch), get_config(arch)
    jflat, _ = jax.tree_util.tree_flatten_with_path(
        j_get_model(jcfg).abstract_params(jcfg))
    tparams = get_model(tcfg).init_params(tcfg, 0, META)
    assert [(p, tuple(x.shape)) for p, x in flatten_with_path(tparams)] == \
        [("/".join(k.key for k in path), tuple(x.shape)) for path, x in jflat]
    assert all(x.device == META for _, x in flatten_with_path(tparams))


def _states(arch):
    """(name, reference state, port state) of the smoke config's serve
    states: dense, and where SWAN applies slab, int8 slab and (transformer
    families) paged."""
    jcfg, tcfg = j_smoke(arch), get_smoke_config(arch)
    japi, tapi = j_get_model(jcfg), get_model(tcfg)
    out = [("dense", jax.eval_shape(
        lambda: japi.init_serve_state(jcfg, None, 2, 32)),
        tapi.init_serve_state(tcfg, None, 2, 32, META))]
    if not swan_applicable(tcfg):
        return out
    for name, kw in (("slab", {}), ("slab-int8", dict(quantize=True))):
        js, ts = JSwan(k_max=8, buffer=4, **kw), SwanConfig(k_max=8, buffer=4,
                                                            **kw)
        out.append((name, jax.eval_shape(
            lambda: japi.init_serve_state(jcfg, js, 2, 32)),
            tapi.init_serve_state(tcfg, ts, 2, 32, META)))
        if tapi.init_paged_state is not None:
            out.append((f"paged{name[4:]}", jax.eval_shape(
                lambda: japi.init_paged_state(jcfg, js, 2, 32, 8, 8)),
                tapi.init_paged_state(tcfg, ts, 2, 32, 8, 8, META)))
    return out


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_serve_state_pspecs_match_reference(arch):
    for name, jstate, tstate in _states(arch):
        assert [p for p, _ in flatten_with_path(tstate)] == \
            _ref_paths(jstate)
        for mesh in MESHES.values():
            m = mesh()
            want = _ref_by_path(jss.serve_state_pspecs(jstate, m))
            got = _mine_by_path(tss.serve_state_pspecs(tstate, m))
            assert got == want, (arch, name, mesh.__name__)
        assert tss.unspecced_serve_leaves(tstate) == \
            jss.unspecced_serve_leaves(jstate)


@pytest.mark.parametrize("arch", [a for a in J_ARCH_IDS
                                  if not j_smoke(a).is_encoder_decoder])
def test_every_engine_state_is_specced(arch):
    """Every leaf of every state the engine builds has a rule (the
    encoder-decoder has no engine, as in the reference)."""
    for name, _, tstate in _states(arch):
        assert tss.unspecced_serve_leaves(tstate) == [], (arch, name)


class MeshM:
    shape = {"model": 16}
    axis_names = ("model",)


class MeshD:
    shape = {"data": 2}
    axis_names = ("data",)


SANITIZE_CASES = [
    (MeshM, ("model", None), (10, 4)),
    (MeshM, ("model", None), (32, 4)),
    (MeshD, (None, "data", None, "model", None), (2, 4, 2, 32, 8)),
    (Mesh3, (None, ("pod", "data"), None, "model"), (3, 64, 2, 16)),
    (Mesh3, (("pod", "data"), "model"), (32, 8)),
    (Mesh2, ("data",), (16, 3, 5)),
]


@pytest.mark.parametrize("case", range(len(SANITIZE_CASES)))
def test_sanitize_matches_reference(case):
    mesh, spec, shape = SANITIZE_CASES[case]
    got = tss._sanitize(P(*spec), shape, mesh())
    assert isinstance(got, PartitionSpec)
    assert tuple(got) == tuple(jss._sanitize(JP(*spec), shape, mesh()))


def test_sanitizer_cases_of_the_reference_tests():
    """``tests/test_sharding.py``'s own expectations."""
    assert tuple(tss._sanitize(P("model", None), (10, 4), MeshM())) == \
        (None, None)
    assert tuple(tss._sanitize(P("model", None), (32, 4), MeshM()))[0] == \
        "model"
    assert tuple(tss._sanitize(P(None, "data", None, "model", None),
                               (2, 4, 2, 32, 8), MeshD())) == \
        (None, "data", None, None, None)


def test_batch_pspecs_and_sanitize_tree_match_reference():
    import numpy as np
    batch = {"tokens": np.zeros((32, 7), np.int32),
             "frames": np.zeros((3, 5, 2), np.float32)}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for mesh in (Mesh2, Mesh3, MeshD):
        want = _ref_by_path(jss.batch_pspecs(batch, mesh()))
        assert _mine_by_path(tss.batch_pspecs(tbatch, mesh())) == want
        specs = {k: P(("pod", "data"), "model", None) for k in batch}
        jspec = {k: JP(("pod", "data"), "model", None) for k in batch}
        assert _mine_by_path(tss.sanitize_tree(specs, tbatch, mesh())) == \
            _ref_by_path(jss.sanitize_tree(jspec, batch, mesh()))


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_activation_rules_match_reference(arch):
    for mesh in MESHES.values():
        for full in (True, False):
            jcfg = j_config(arch) if full else j_smoke(arch)
            tcfg = get_config(arch) if full else get_smoke_config(arch)
            want = jspecs.activation_rules(jcfg, mesh()).kinds
            got = tspecs.activation_rules(tcfg, mesh())
            assert {k: tuple(v) for k, v in got.kinds.items()} == \
                {k: tuple(v) for k, v in want.items()}
            assert got.spec("residual") == got.kinds["residual"]
            assert got.spec("nope") is None
    assert tspecs.dp_axes(Mesh3()) == jspecs.dp_axes(Mesh3()) == \
        ("pod", "data")


def test_use_rules_nests_and_restores():
    assert current_rules() is None and j_current_rules() is None
    a, b = ShardingRules(Mesh2(), {}), ShardingRules(Mesh3(), {})
    with use_rules(a):
        assert current_rules() is a
        with use_rules(b):
            assert current_rules() is b
        assert current_rules() is a
    assert current_rules() is None
    assert repr(P("data", None)) == "P('data', None)"
    # jax's canonical entries: a one-name tuple is the name
    for entries in ((("data",), None), ((), "model"), (("pod", "data"),)):
        assert tuple(P(*entries)) == tuple(JP(*entries))
