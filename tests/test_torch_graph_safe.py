"""Graph safety of the port's engine dispatches, checked without a card.

A CUDA graph cannot hold a dispatch that reads a value back to the host or
whose shapes follow the schedule.  Here each decode and chunk dispatch of
``ServeEngine`` (slab, paged, dense; llama3-8b's smoke config, and both
MoE smoke configs) runs eagerly on the CPU under a ``TorchDispatchMode``
recorder:

* it calls no op that reads a tensor's value on the host or sizes a
  result by its data (``aten::nonzero``, ``aten::_local_scalar_dense``,
  ``masked_select``, ...), builds no tensor from host data, and converts
  nothing to numpy or Python;
* two different schedules in one bucket (other live lanes, positions,
  starts, lengths and k) call the same ops on the same shapes;
* with metrics and an event trace on, which record each dispatch from
  host state alone.

The fixed-shape chunk writes (``hybrid_cache.lane_writes``, applied by
``apply_lane_writes_``) are also held to a plain loop over the live
lanes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import SwanConfig, get_smoke_config  # noqa: E402
from repro_torch.core import hybrid_cache as hc  # noqa: E402
from repro_torch.launch.io import make_batch  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.obs import EventTrace  # noqa: E402
from repro_torch.runtime.serve_engine import ServeEngine  # noqa: E402
from repro_torch.runtime.serve_loop import calibrate_swan  # noqa: E402

N_SLOTS, MAX_SEQ, PAGE, LANES, CHUNK = 4, 64, 8, 4, 8

HOST_READS = ("nonzero", "nonzero_static", "_local_scalar_dense", "item",
              "masked_select", "unique", "_unique", "_unique2",
              "unique_consecutive", "unique_dim", "lift_fresh",
              "lift_fresh_copy", "argwhere")


class _Recorder(TorchDispatchMode):
    """Every aten op with the shapes of its tensor arguments."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        shapes = []

        def visit(x):
            if isinstance(x, torch.Tensor):
                shapes.append((tuple(x.shape), x.dtype))
            elif isinstance(x, (list, tuple)):
                for y in x:
                    visit(y)
        for a in list(args) + list(kwargs.values()):
            visit(a)
        self.ops.append((func.overloadpacket.__name__, tuple(shapes)))
        return func(*args, **kwargs)


def _no_host_conversions(monkeypatch):
    def refuse(self, *a, **k):
        raise AssertionError("a tensor went to the host inside a dispatch")
    for name in ("numpy", "tolist", "__array__", "__int__", "__index__",
                 "__float__", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


def _model(arch):
    cfg = get_smoke_config(arch).replace(dtype="float32",
                                         param_dtype="float32")
    api = get_model(cfg)
    params = api.init_params(cfg, 0, "cpu")
    pj = calibrate_swan(api, cfg, params, make_batch(cfg, 2, 16,
                                                     device="cpu"))
    return cfg, params, api.absorb(params, cfg, pj), pj


@pytest.fixture(scope="module")
def model():
    return _model("llama3-8b")


@pytest.fixture(scope="module", params=["deepseek-moe-16b",
                                        "qwen2-moe-a2.7b"])
def moe_model(request):
    """A MoE smoke config: the experts' fixed-capacity scatter and
    slot-order combine inside every dispatch."""
    return _model(request.param)


def _engine(model, layout):
    cfg, params, absorbed, pj = model
    kw = dict(max_seq=MAX_SEQ, n_slots=N_SLOTS, prefill_chunk=CHUNK,
              prefill_slots=LANES, metrics=True, trace=EventTrace(),
              device="cpu")
    if layout == "dense":
        return ServeEngine(cfg, params, **kw)
    if layout == "paged":
        kw.update(paged=True, page_size=PAGE)
    return ServeEngine(cfg, absorbed, swan=SwanConfig(k_max=8, buffer=4),
                       projections=pj, **kw)


def _schedules(kind, layout):
    """Two schedules of one bucket: operands as CPU tensors."""
    rng = np.random.default_rng(0 if kind == "decode" else 1)
    out = []
    for live in ([0, 2], [1, 2, 3]):
        if kind == "decode":
            pos = np.full((N_SLOTS,), -1, np.int32)
            pos[live] = rng.integers(0, MAX_SEQ - 1, len(live))
            out.append([torch.as_tensor(rng.integers(0, 200, N_SLOTS)
                                        .astype(np.int32)),
                        torch.as_tensor(pos),
                        torch.as_tensor(rng.integers(1, 9, N_SLOTS)
                                        .astype(np.int32))])
        else:
            slot = np.full((LANES,), N_SLOTS, np.int64)
            slot[:len(live)] = live
            out.append([torch.as_tensor(rng.integers(0, 200, (LANES, CHUNK))),
                        torch.as_tensor(slot),
                        torch.as_tensor(rng.integers(0, 32, LANES)),
                        torch.as_tensor(rng.integers(1, CHUNK + 1, LANES)),
                        torch.as_tensor(rng.integers(1, 9, LANES))])
    return out


def _check_dispatches(model, layout, kind, monkeypatch):
    eng = _engine(model, layout)
    width = 4 if layout == "paged" else None
    if width is not None:
        for i in range(N_SLOTS):                  # a mapped table prefix
            eng.pool.ensure(i, 24)
        eng._device_table(width)                  # uploaded outside
    n_events = len(eng.trace.events)              # the pages' page_map
    traces = []
    for operands in _schedules(kind, layout):
        rec = _Recorder()
        with monkeypatch.context() as m:
            _no_host_conversions(m)
            with rec:
                if kind == "decode":
                    logits, greedy = eng._decode_call(*operands, width)
                else:
                    logits, greedy = eng._chunk_call(
                        *operands, width, None if width else MAX_SEQ)
        assert logits.shape[0] == greedy.shape[0]
        bad = sorted({op for op, _ in rec.ops if op in HOST_READS})
        assert not bad, bad
        traces.append(rec.ops)
    assert len(traces[0]) > 100
    assert traces[0] == traces[1]
    timed = eng.metrics.get("serve_dispatch_ms", kind=kind, kernel="torch")
    assert timed.count == 2 and len(eng.trace.events) == n_events


@pytest.mark.parametrize("kind", ["decode", "chunk"])
@pytest.mark.parametrize("layout", ["slab", "paged", "dense"])
def test_dispatch_reads_nothing_back_and_follows_the_bucket(model, layout,
                                                             kind,
                                                             monkeypatch):
    _check_dispatches(model, layout, kind, monkeypatch)


@pytest.mark.parametrize("kind", ["decode", "chunk"])
@pytest.mark.parametrize("layout", ["slab", "paged", "dense"])
def test_moe_dispatch_reads_nothing_back_and_follows_the_bucket(
        moe_model, layout, kind, monkeypatch):
    assert moe_model[0].moe is not None
    _check_dispatches(moe_model, layout, kind, monkeypatch)


# ---------------------------------------------------------------------------
# the fixed-shape writes against a loop over the live lanes
# ---------------------------------------------------------------------------

WRITES = {
    # (lanes [P], starts [P], n batch lanes, rows R, chunk S)
    "live_and_dead": ([0, 2, 3, 3], [0, 5, 9, 0], 3, 16, 4),
    "past_the_slab": ([1, 0], [14, 3], 2, 16, 4),
    "all_dead": ([2, 2, 5], [0, 3, 1], 2, 8, 8),
    "more_lanes_than_slots": ([1, 3, 0, 3], [6, 1, 4, 2], 3, 8, 8),
}


@pytest.mark.parametrize("name", list(WRITES))
def test_write_lane_rows_equals_a_loop(name):
    lane, start, n, R, S = WRITES[name]
    rng = np.random.default_rng(7)
    P = len(lane)
    dst = torch.as_tensor(rng.standard_normal((n, 2, R, 3)), dtype=torch.float32)
    new = torch.as_tensor(rng.standard_normal((P, S, 2, 3)), dtype=torch.float32)
    want = dst.clone()
    for p in range(P):
        if lane[p] >= n:
            continue
        for s in range(S):
            if start[p] + s < R:
                want[lane[p], :, start[p] + s] = new[p, s]
    hc.apply_lane_writes_(dst, new, hc.lane_writes(np.asarray(lane), n,
                                                   np.asarray(start), S, R))
    assert torch.equal(dst, want)
    ring = torch.as_tensor(rng.standard_normal((n, 5)), dtype=torch.float32)
    ring_new = torch.as_tensor(rng.standard_normal((P, 5)), dtype=torch.float32)
    want = ring.clone()
    for p in range(P):
        if lane[p] < n:
            want[lane[p]] = ring_new[p]
    hc.write_lanes_(ring, ring_new, torch.as_tensor(lane))
    assert torch.equal(ring, want)
