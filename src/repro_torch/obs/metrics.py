"""Dependency-free metrics registry: counters, gauges, fixed-bucket
histograms; Prometheus-text and JSON snapshot exporters.

The port's own copy of ``repro.obs.metrics`` (pure Python; the port imports
nothing of the JAX package): the same instruments, the same Prometheus text
and JSON snapshot, byte for byte (``tests/test_torch_obs.py``).

Design constraints (serving-stack contract):

* HOST-SIDE ONLY.  Instruments are plain Python objects mutated by the
  scheduler between dispatches; nothing here touches a tensor or runs
  inside a captured CUDA graph.  No instrument ever reads a wall clock —
  callers that want wall time use :func:`repro_torch.obs.trace.span`;
  everything the engine records is step-indexed (engine scheduler steps),
  so metrics are deterministic across hosts.
* Fixed buckets.  Histograms take their bucket upper bounds at creation
  (power-of-two defaults suit step-indexed latencies); observations only
  bump integer counts, so snapshots are cheap and exact to re-serialize.
* Labels are plain keyword arguments; each distinct label set is its own
  series under the metric family, exactly as in Prometheus.

Round-trip guarantee: ``MetricsRegistry.from_snapshot(reg.snapshot())``
re-creates an identical registry, and every registered series appears in
``to_prometheus()`` output (``parse_prometheus`` reads it back).
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotone counter (``inc`` only)."""
    kind = "counter"
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: float = 0

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self.value += n


class Gauge:
    """Point-in-time value (``set``/``inc``/``dec``)."""
    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: float = 0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1) -> None:
        self.value += n

    def dec(self, n: float = 1) -> None:
        self.value -= n


class Histogram:
    """Fixed-bucket histogram: ``counts[i]`` observations with
    ``value <= uppers[i]``, plus an overflow bucket (+Inf), an exact
    ``sum`` and a total ``count``."""
    kind = "histogram"
    __slots__ = ("uppers", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float]):
        if not buckets:
            raise ValueError("histogram needs at least one bucket bound")
        uppers = tuple(float(b) for b in buckets)
        if list(uppers) != sorted(set(uppers)):
            raise ValueError(f"buckets must be strictly increasing: {uppers}")
        self.uppers = uppers
        self.counts = [0] * (len(uppers) + 1)       # +1: overflow (+Inf)
        self.sum: float = 0.0
        self.count: int = 0

    def observe(self, v: float) -> None:
        i = 0
        for i, ub in enumerate(self.uppers):
            if v <= ub:
                break
        else:
            i = len(self.uppers)
        self.counts[i] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile estimate (upper bound of the bucket
        holding the q-th observation; NaN when empty).  Good enough for
        periodic stats lines — exact percentiles come from the trace."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q={q} outside [0, 1]")
        if self.count == 0:
            return math.nan
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                return (self.uppers[i] if i < len(self.uppers)
                        else math.inf)
        return math.inf

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Named families of instruments, each holding one series per label
    set.  Getter methods are idempotent: asking for an existing
    (name, labels) returns the same instrument; asking for an existing
    name with a different kind (or different histogram buckets) raises —
    a metric's schema is fixed at registration."""

    enabled = True

    def __init__(self) -> None:
        # name -> {"kind", "help", "buckets"?, "series": {labelkey: inst}}
        self._families: Dict[str, Dict[str, Any]] = {}

    # -- registration --------------------------------------------------

    def _family(self, name: str, kind: str, help: str,
                buckets: Optional[Sequence[float]]) -> Dict[str, Any]:
        fam = self._families.get(name)
        if fam is None:
            fam = {"kind": kind, "help": help, "series": {}}
            if kind == "histogram":
                fam["buckets"] = tuple(float(b) for b in buckets)
            self._families[name] = fam
            return fam
        if fam["kind"] != kind:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{fam['kind']}, not {kind}")
        if kind == "histogram" and buckets is not None \
                and tuple(float(b) for b in buckets) != fam["buckets"]:
            raise ValueError(f"histogram {name!r} re-registered with "
                             "different buckets")
        if help and not fam["help"]:
            fam["help"] = help
        return fam

    def _series(self, name: str, kind: str, help: str,
                buckets: Optional[Sequence[float]], labels: Dict[str, Any]):
        fam = self._family(name, kind, help, buckets)
        key = _label_key(labels)
        inst = fam["series"].get(key)
        if inst is None:
            inst = (Histogram(fam["buckets"]) if kind == "histogram"
                    else _KINDS[kind]())
            fam["series"][key] = inst
        return inst

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._series(name, "counter", help, None, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._series(name, "gauge", help, None, labels)

    def histogram(self, name: str, buckets: Sequence[float],
                  help: str = "", **labels) -> Histogram:
        return self._series(name, "histogram", help, buckets, labels)

    # -- lookup --------------------------------------------------------

    def get(self, name: str, **labels):
        """Existing instrument for (name, labels), or None."""
        fam = self._families.get(name)
        if fam is None:
            return None
        return fam["series"].get(_label_key(labels))

    def value(self, name: str, default: float = 0, **labels) -> float:
        """Counter/gauge value for (name, labels); ``default`` if the
        series does not exist."""
        inst = self.get(name, **labels)
        if inst is None:
            return default
        if isinstance(inst, Histogram):
            raise TypeError(f"{name!r} is a histogram — read .count/.sum "
                            "or quantile() off get()")
        return inst.value

    def names(self) -> List[str]:
        return sorted(self._families)

    # -- exporters -----------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able full dump: every family, every series, exact state."""
        out: Dict[str, Any] = {}
        for name in sorted(self._families):
            fam = self._families[name]
            entry: Dict[str, Any] = {"kind": fam["kind"],
                                     "help": fam["help"], "series": []}
            if fam["kind"] == "histogram":
                entry["buckets"] = list(fam["buckets"])
            for key in sorted(fam["series"]):
                inst = fam["series"][key]
                ser: Dict[str, Any] = {"labels": dict(key)}
                if isinstance(inst, Histogram):
                    ser.update(counts=list(inst.counts), sum=inst.sum,
                               count=inst.count)
                else:
                    ser["value"] = inst.value
                entry["series"].append(ser)
            out[name] = entry
        return {"metrics": out}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    @classmethod
    def from_snapshot(cls, snap: Dict[str, Any]) -> "MetricsRegistry":
        """Inverse of :meth:`snapshot`: ``from_snapshot(s).snapshot() ==
        s``."""
        reg = cls()
        for name, fam in snap.get("metrics", {}).items():
            for ser in fam["series"]:
                labels = ser["labels"]
                if fam["kind"] == "histogram":
                    h = reg.histogram(name, fam["buckets"], fam["help"],
                                      **labels)
                    h.counts = list(ser["counts"])
                    h.sum = ser["sum"]
                    h.count = ser["count"]
                elif fam["kind"] == "counter":
                    reg.counter(name, fam["help"], **labels).value = \
                        ser["value"]
                else:
                    reg.gauge(name, fam["help"], **labels).set(ser["value"])
            # families registered with zero series survive the trip too
            if not fam["series"]:
                reg._family(name, fam["kind"], fam["help"],
                            fam.get("buckets"))
        return reg

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (counters/gauges verbatim;
        histograms as cumulative ``_bucket{le=}``/``_sum``/``_count``)."""
        lines: List[str] = []
        for name in sorted(self._families):
            fam = self._families[name]
            if fam["help"]:
                lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['kind']}")
            for key in sorted(fam["series"]):
                inst = fam["series"][key]
                if isinstance(inst, Histogram):
                    cum = 0
                    for ub, c in zip(inst.uppers, inst.counts):
                        cum += c
                        lines.append(f"{name}_bucket"
                                     f"{_fmt_labels(key, le=_fmt_num(ub))}"
                                     f" {cum}")
                    cum += inst.counts[-1]
                    lines.append(f"{name}_bucket"
                                 f"{_fmt_labels(key, le='+Inf')} {cum}")
                    lines.append(f"{name}_sum{_fmt_labels(key)} "
                                 f"{_fmt_num(inst.sum)}")
                    lines.append(f"{name}_count{_fmt_labels(key)} {cum}")
                else:
                    lines.append(f"{name}{_fmt_labels(key)} "
                                 f"{_fmt_num(inst.value)}")
        return "\n".join(lines) + "\n"


def _fmt_num(v: float) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def _fmt_labels(key: _LabelKey, **extra: str) -> str:
    items = list(key) + sorted(extra.items())
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + body + "}"


def parse_prometheus(text: str) -> Dict[str, Any]:
    """Minimal reader for :meth:`MetricsRegistry.to_prometheus` output —
    enough for the round-trip schema guard.  Returns
    ``{"types": {name: kind}, "samples": {(sample_name, labelkey): value}}``
    where histogram samples keep their ``_bucket``/``_sum``/``_count``
    suffixes and the ``le`` label."""
    types: Dict[str, str] = {}
    samples: Dict[Tuple[str, _LabelKey], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        body, val = line.rsplit(None, 1)
        if "{" in body:
            name, rest = body.split("{", 1)
            rest = rest.rstrip("}")
            labels = {}
            for item in rest.split(","):
                k, v = item.split("=", 1)
                labels[k] = v.strip('"')
        else:
            name, labels = body, {}
        samples[(name, _label_key(labels))] = float(val)
    return {"types": types, "samples": samples}


class _NullInstrument:
    """Absorbs every instrument method; reads as zero/empty."""
    kind = "null"
    value = 0
    sum = 0.0
    count = 0
    counts: List[int] = []
    uppers: Tuple[float, ...] = ()
    mean = math.nan

    def inc(self, n: float = 1) -> None: pass
    def dec(self, n: float = 1) -> None: pass
    def set(self, v: float) -> None: pass
    def observe(self, v: float) -> None: pass
    def quantile(self, q: float) -> float: return math.nan


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry(MetricsRegistry):
    """Disabled registry: every getter returns a shared no-op instrument
    and snapshots are empty.  ``ServeEngine(metrics=False)`` uses this so
    the instrumented call sites stay unconditional — the on/off
    token-identity test relies on both modes running the exact same
    scheduler code."""

    enabled = False

    def counter(self, name, help="", **labels):  # type: ignore[override]
        return _NULL_INSTRUMENT

    def gauge(self, name, help="", **labels):  # type: ignore[override]
        return _NULL_INSTRUMENT

    def histogram(self, name, buckets, help="", **labels):  # type: ignore[override]
        return _NULL_INSTRUMENT

    def get(self, name, **labels):
        return None


NULL_REGISTRY = NullRegistry()
