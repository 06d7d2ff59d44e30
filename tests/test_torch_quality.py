"""Port parity for the quality benchmarks' scoring: teacher-forced NLL
through the serving path at one setting per bench, the long-context
drift, and the adaptive-k allocation (the end-to-end bench run is in
``test_torch_quality_bench.py``)."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ModelConfig as JModelConfig  # noqa: E402
from repro.configs import SwanConfig as JSwan  # noqa: E402
from repro.core import adaptive as jadaptive  # noqa: E402
from repro.core import projections as jproj  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro_torch.benchmarks import common as tcommon  # noqa: E402
from repro_torch.configs import SwanConfig  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core import adaptive as tadaptive  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run hundreds of tiny eager ops,
    which extra threads only slow down when the suite's workers share the
    cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ref():
    """The quality benches' tiny LM with the reference's init weights, its
    projections (calibrated by the reference) and the absorbed weights,
    in both packages; and a short held-out batch."""
    ref_common = _ref_common()
    tcfg = tcommon.tiny_lm_config()
    jcfg = JModelConfig(**{**tcfg.__dict__, "norm": "rmsnorm"})
    api = j_get_model(jcfg)
    params = api.init_params(jax.random.PRNGKey(0), jcfg)
    calib = tcommon.eval_tokens(tcfg, 4, 48, 50_000, device="cpu").numpy()
    q, k, v, wo = api.collect_qkv(params, jcfg, {"tokens": jnp.asarray(calib)})
    pj = jproj.compute_projections((q, k, v), wo, jcfg.n_heads,
                                   jcfg.n_kv_heads, jcfg.d_head)
    absorbed = api.absorb(params, jcfg, pj)
    tokens = np.array(ref_common.eval_tokens(jcfg, batch=4, seq=40))
    t = lambda x: to_torch(x, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, common=ref_common,
                j=(params, pj, absorbed, jnp.asarray(tokens)),
                t=(t(params), t(pj), t(absorbed), torch.as_tensor(tokens)))


def _ref_common():
    """The reference's ``benchmarks/common.py`` (a package at the repo
    root, next to ``src``)."""
    import sys
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import benchmarks.common as ref_common
    return ref_common


# (label, SwanConfig kwargs, use a k_layer allocation): one per bench
SETTINGS = [
    ("table1_bt8", dict(k_max=16, buffer=8), False),
    ("table2_bt0_split", dict(k_max=21, buffer=0, k_key=11, k_value=21),
     False),
    ("table3_bt0_half", dict(k_max=16, buffer=0), False),
    ("fig2b_bt8_int8", dict(k_max=6, buffer=8, quantize=True), False),
    ("adaptive_k_layer", dict(k_max=32, buffer=8, k_key=8, k_value=8), True),
]


@pytest.mark.parametrize("label,kw,adaptive", SETTINGS,
                         ids=[s[0] for s in SETTINGS])
def test_teacher_forced_nll_matches_reference(ref, label, kw, adaptive):
    jparams, jpj, jabs, jtok = ref["j"]
    tparams, tpj, tabs, ttok = ref["t"]
    if adaptive:
        spec = jadaptive.spectra_from_joint(jpj["spectrum_qk"])
        k_ad = jadaptive.allocate_k(spec, 8, k_min=4, k_max=16)
        jpj = {**jpj, "k_layer": jnp.asarray(k_ad)}
        tpj = {**tpj, "k_layer": torch.as_tensor(k_ad)}
    want = ref["common"].swan_teacher_forced_nll(ref["jcfg"], jabs, jtok,
                                                 JSwan(**kw), jpj)
    got = tcommon.swan_teacher_forced_nll(ref["tcfg"], tabs, ttok,
                                          SwanConfig(**kw), tpj)
    assert abs(got - want) <= TOL, (label, got, want)


def test_dense_nll_matches_reference(ref):
    jparams, _, _, jtok = ref["j"]
    tparams, _, _, ttok = ref["t"]
    want = ref["common"].swan_teacher_forced_nll(ref["jcfg"], jparams, jtok,
                                                 None)
    got = tcommon.swan_teacher_forced_nll(ref["tcfg"], tparams, ttok, None)
    assert abs(got - want) <= TOL, (got, want)


def test_longcontext_drift_matches_reference(ref):
    import benchmarks.bench_longcontext_error as jbench
    from repro_torch.benchmarks import bench_longcontext_error as tbench
    jparams, jpj, jabs, jtok = ref["j"]
    tparams, tpj, tabs, ttok = ref["t"]
    kw = dict(k_max=4, buffer=8)
    want = jbench._drift(ref["jcfg"], jparams, jabs, jpj, JSwan(**kw), jtok)
    got = tbench._drift(ref["tcfg"], tparams, tabs, tpj, SwanConfig(**kw),
                        ttok)
    assert sorted(got) == sorted(want) == [32]
    for t in want:
        assert abs(got[t][0] - want[t][0]) <= 1e-9       # top-1 agreement
        assert abs(got[t][1] - want[t][1]) <= TOL        # max logit error


@pytest.mark.parametrize("avg_k,k_min,k_max", [(8, 4, 16), (4, 2, 8),
                                               (3, 1, None)])
def test_adaptive_allocation_equal(avg_k, k_min, k_max):
    e = np.sort(np.random.default_rng(avg_k).gamma(
        0.6, size=(5, 2, 32)), axis=-1)[..., ::-1]
    js = jadaptive.spectra_from_joint(jnp.asarray(e, jnp.float32))
    ts = tadaptive.spectra_from_joint(torch.as_tensor(e.copy()).float())
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(
        tadaptive.allocate_k(ts, avg_k, k_min=k_min, k_max=k_max),
        jadaptive.allocate_k(js, avg_k, k_min=k_min, k_max=k_max))
    np.testing.assert_array_equal(tadaptive.uniform_k(5, avg_k),
                                  jadaptive.uniform_k(5, avg_k))
