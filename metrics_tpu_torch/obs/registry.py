"""Process-global metrics registry and the master switch
(port of ``metrics_tpu/obs/registry.py``).

One ``Registry`` instance (:data:`REGISTRY`) serves the process; instruments
(counters, gauges, histograms with explicit bucket edges) are get-or-create by
name, so independent subsystems share series instead of colliding. Reads give
plain dicts (:meth:`Registry.snapshot`), the Prometheus v0.0.4 text
exposition (:meth:`Registry.render_prometheus`, the same text as the JAX
package's for the same series) and JSONL lines through
:mod:`metrics_tpu_torch.obs.jsonl`. :meth:`_Instrument.drop_labels` evicts a
finished owner's series (an engine's ``engine=<id>`` family).

Every instrumentation hook tests ``OBS.enabled`` (one attribute load) before
doing any work, so the disabled library does no telemetry work at all. Direct
registry use is not gated: the engine's telemetry always records. Stdlib only.
"""

from __future__ import annotations

import re
import threading
from bisect import bisect_left
from typing import Any, Dict, Iterable, List, Optional, Tuple

from metrics_tpu_torch.obs.jsonl import append_jsonl


class ObsGate:
    """The one master switch. A bare attribute (``OBS.enabled``) so the hot-path
    check in ``Metric._wrap_update`` et al. is a single LOAD_ATTR, not a call."""

    __slots__ = ("enabled",)

    def __init__(self) -> None:
        self.enabled = False


OBS = ObsGate()

# Prometheus text-format identifier grammars (exposition format v0.0.4).
_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

LabelKey = Tuple[Tuple[str, str], ...]

# Default histogram edges: latency-shaped (seconds), 1µs → 10s decades.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0,
)


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    """Canonical hashable identity of a label set (sorted, stringified values)."""
    if not labels:
        return ()
    for name in labels:
        if not _LABEL_NAME_RE.match(name):
            raise ValueError(f"invalid Prometheus label name {name!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape_label_value(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    """Prometheus sample value: integral counts render without a fraction."""
    f = float(v)
    if f != f:  # NaN
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _render_labels(key: LabelKey, extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = key + extra
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in pairs)
    return "{" + body + "}"


def _key_str(key: LabelKey) -> str:
    """Human-readable label identity for ``snapshot()`` dict keys."""
    return ",".join(f"{k}={v}" for k, v in key)


class _Instrument:
    """Base: a named family of samples, one value slot per label set."""

    kind = "untyped"

    def __init__(self, name: str, help: str) -> None:
        self.name = name
        self.help = help
        self._lock = threading.Lock()

    def label_key(self, **labels: Any) -> LabelKey:
        """Precompute (and validate) a label identity once; hot paths can then
        use the ``*_key`` fast variants and skip per-call validation/sorting."""
        return _label_key(labels)

    def _value_maps(self) -> Tuple[Dict[LabelKey, Any], ...]:
        raise NotImplementedError

    def drop_labels(self, **labels: Any) -> None:
        """Evict every series whose label set CONTAINS ``labels`` (e.g. one
        engine's ``engine=<id>`` family) — the anti-leak hook for subsystems
        that materialise per-instance series in the process-global registry."""
        match = set(_label_key(labels))
        with self._lock:
            for values in self._value_maps():
                for key in [k for k in values if match <= set(k)]:
                    del values[key]

    def clear(self) -> None:
        raise NotImplementedError


class Counter(_Instrument):
    """Monotone counter family. ``inc`` is the only mutator; negative increments
    raise (a counter that goes down is a gauge)."""

    kind = "counter"

    def __init__(self, name: str, help: str) -> None:
        super().__init__(name, help)
        self._values: Dict[LabelKey, float] = {}

    def inc(self, n: float = 1, **labels: Any) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease (inc({n}))")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + n

    def inc_key(self, key: LabelKey, n: float = 1) -> None:
        """Hot-path inc with a :meth:`label_key`-precomputed identity (no
        per-call validation/sorting/stringification)."""
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease (inc({n}))")
        with self._lock:
            self._values[key] = self._values.get(key, 0) + n

    def inc_many_keys(self, updates: Iterable[Tuple[float, LabelKey]]) -> None:
        """``inc_many`` over precomputed keys: one lock, zero per-call label work."""
        updates = list(updates)
        if any(n < 0 for n, _ in updates):
            raise ValueError(f"counter {self.name!r} cannot decrease (inc_many_keys)")
        with self._lock:
            for n, key in updates:
                self._values[key] = self._values.get(key, 0) + n

    def inc_many(self, updates: Iterable[Tuple[float, Dict[str, Any]]]) -> None:
        """Apply several ``(n, labels)`` increments under ONE lock acquisition.

        For multi-series invariants (e.g. the engine's rows/padded_rows/batches
        per dispatched micro-batch): a concurrent ``collect()`` sees either all
        of the group's increments or none, never a partial batch.
        """
        keyed = [(float(n), _label_key(labels)) for n, labels in updates]
        if any(n < 0 for n, _ in keyed):
            raise ValueError(f"counter {self.name!r} cannot decrease (inc_many)")
        with self._lock:
            for n, key in keyed:
                self._values[key] = self._values.get(key, 0) + n

    def touch(self, **labels: Any) -> None:
        """Materialise a zero-valued series so exports show it before first inc."""
        key = _label_key(labels)
        with self._lock:
            self._values.setdefault(key, 0)

    def value(self, **labels: Any) -> float:
        key = _label_key(labels)
        with self._lock:
            return self._values.get(key, 0)

    def collect(self) -> Dict[LabelKey, float]:
        with self._lock:
            return dict(self._values)

    def _value_maps(self) -> Tuple[Dict[LabelKey, Any], ...]:
        return (self._values,)

    def clear(self) -> None:
        with self._lock:
            self._values.clear()


class Gauge(_Instrument):
    """Point-in-time value family (queue depths, capacities, flags)."""

    kind = "gauge"

    def __init__(self, name: str, help: str) -> None:
        super().__init__(name, help)
        self._values: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels: Any) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = float(value)

    def set_key(self, key: LabelKey, value: float) -> None:
        """Hot-path set with a precomputed label identity."""
        with self._lock:
            self._values[key] = float(value)

    def inc(self, n: float = 1, **labels: Any) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + n

    def value(self, **labels: Any) -> float:
        key = _label_key(labels)
        with self._lock:
            return self._values.get(key, 0)

    def collect(self) -> Dict[LabelKey, float]:
        with self._lock:
            return dict(self._values)

    def _value_maps(self) -> Tuple[Dict[LabelKey, Any], ...]:
        return (self._values,)

    def clear(self) -> None:
        with self._lock:
            self._values.clear()


class Histogram(_Instrument):
    """Bucketed distribution family with per-label-set (buckets, sum, count).

    Buckets are upper-inclusive edges (Prometheus ``le`` semantics); an implicit
    ``+Inf`` overflow bucket always exists. Stored counts are per-bucket
    (non-cumulative); the Prometheus renderer emits the cumulative form the
    text format requires.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str, buckets: Iterable[float] = DEFAULT_BUCKETS) -> None:
        super().__init__(name, help)
        edges = sorted(float(b) for b in buckets)
        if not edges:
            raise ValueError(f"histogram {self.name!r} needs at least one bucket edge")
        if any(e != e or e in (float("inf"), float("-inf")) for e in edges):
            raise ValueError(f"histogram {self.name!r} edges must be finite (``+Inf`` is implicit)")
        if len(set(edges)) != len(edges):
            raise ValueError(f"histogram {self.name!r} has duplicate bucket edges")
        self.edges: Tuple[float, ...] = tuple(edges)
        # labelkey -> [per-bucket counts... , overflow]; plus running sum/count
        self._buckets: Dict[LabelKey, List[int]] = {}
        self._sums: Dict[LabelKey, float] = {}
        self._counts: Dict[LabelKey, int] = {}

    def observe(self, value: float, **labels: Any) -> None:
        self.observe_key(_label_key(labels), value)

    def observe_key(self, key: LabelKey, value: float) -> None:
        """Hot-path observe with a precomputed label identity."""
        v = float(value)
        idx = bisect_left(self.edges, v)  # first edge >= v, i.e. smallest le-bucket
        with self._lock:
            row = self._buckets.get(key)
            if row is None:
                row = self._buckets[key] = [0] * (len(self.edges) + 1)
            row[idx] += 1
            self._sums[key] = self._sums.get(key, 0.0) + v
            self._counts[key] = self._counts.get(key, 0) + 1

    def touch(self, **labels: Any) -> None:
        key = _label_key(labels)
        with self._lock:
            self._buckets.setdefault(key, [0] * (len(self.edges) + 1))
            self._sums.setdefault(key, 0.0)
            self._counts.setdefault(key, 0)

    def bucket_counts(self, **labels: Any) -> Dict[float, int]:
        """Per-edge (non-cumulative) counts; the overflow bucket under ``inf``."""
        key = _label_key(labels)
        with self._lock:
            row = self._buckets.get(key, [0] * (len(self.edges) + 1))
            out = {edge: row[i] for i, edge in enumerate(self.edges)}
            out[float("inf")] = row[-1]
            return out

    def count(self, **labels: Any) -> int:
        key = _label_key(labels)
        with self._lock:
            return self._counts.get(key, 0)

    def sum(self, **labels: Any) -> float:
        key = _label_key(labels)
        with self._lock:
            return self._sums.get(key, 0.0)

    def collect(self) -> Dict[LabelKey, Tuple[List[int], float, int]]:
        with self._lock:
            return {
                key: (list(row), self._sums.get(key, 0.0), self._counts.get(key, 0))
                for key, row in self._buckets.items()
            }

    def _value_maps(self) -> Tuple[Dict[LabelKey, Any], ...]:
        return (self._buckets, self._sums, self._counts)

    def clear(self) -> None:
        with self._lock:
            self._buckets.clear()
            self._sums.clear()
            self._counts.clear()


class Registry:
    """Thread-safe, ordered, get-or-create home for instrument families.

    Re-requesting a name returns the existing instrument; a kind (or, for
    histograms, bucket-edge) mismatch raises instead of silently forking the
    series — two subsystems disagreeing about what a name means is a bug.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}

    def _get_or_create(self, cls: type, name: str, help: str, **kwargs: Any) -> Any:
        if not _METRIC_NAME_RE.match(name):
            raise ValueError(f"invalid Prometheus metric name {name!r}")
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                create_kwargs = dict(kwargs)
                if cls is Histogram:
                    create_kwargs.setdefault("buckets", DEFAULT_BUCKETS)
                inst = cls(name, help, **create_kwargs)
                self._instruments[name] = inst
                return inst
        if not isinstance(inst, cls):
            raise TypeError(
                f"registry name {name!r} is already a {inst.kind}, requested {cls.kind}"  # type: ignore[attr-defined]
            )
        if cls is Histogram and "buckets" in kwargs:
            requested = tuple(sorted(float(b) for b in kwargs["buckets"]))
            if requested != inst.edges:  # type: ignore[union-attr]
                raise ValueError(
                    f"histogram {name!r} already registered with edges {inst.edges}, requested {requested}"  # type: ignore[union-attr]
                )
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "", buckets: Optional[Iterable[float]] = None) -> Histogram:
        """Get or create a histogram. ``buckets=None`` means "whatever edges the
        family has" (DEFAULT_BUCKETS when creating) — only an EXPLICIT edge set
        is checked against an existing family, so a plain get of a custom-edge
        histogram never trips the conflict check."""
        if buckets is None:
            return self._get_or_create(Histogram, name, help)
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._instruments.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return list(self._instruments)

    # ------------------------------------------------------------------ reading

    def snapshot(self) -> Dict[str, Any]:
        """Everything as one plain dict (logs, dashboards, jsonl).

        Shape per family: ``{"type", "help", "values"}`` where ``values`` maps a
        ``"k=v,k2=v2"`` label string (``""`` for the unlabeled series) to the
        sample — a number for counters/gauges, ``{"buckets", "sum", "count"}``
        for histograms (bucket keys are the stringified upper edges, ``"inf"``
        for overflow).
        """
        with self._lock:
            instruments = list(self._instruments.items())
        out: Dict[str, Any] = {}
        for name, inst in instruments:
            if isinstance(inst, Histogram):
                values: Dict[str, Any] = {}
                for key, (row, total, count) in inst.collect().items():
                    buckets = {str(edge): row[i] for i, edge in enumerate(inst.edges)}
                    buckets["inf"] = row[-1]
                    values[_key_str(key)] = {"buckets": buckets, "sum": total, "count": count}
            else:
                values = {_key_str(key): v for key, v in inst.collect().items()}
            out[name] = {"type": inst.kind, "help": inst.help, "values": values}
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format v0.0.4 (``text/plain; version=0.0.4``)."""
        with self._lock:
            instruments = list(self._instruments.items())
        lines: List[str] = []
        for name, inst in instruments:
            if inst.help:
                lines.append(f"# HELP {name} {_escape_help(inst.help)}")
            lines.append(f"# TYPE {name} {inst.kind}")
            if isinstance(inst, Histogram):
                for key, (row, total, count) in sorted(inst.collect().items()):
                    cumulative = 0
                    for i, edge in enumerate(inst.edges):
                        cumulative += row[i]
                        labels = _render_labels(key, (("le", _fmt_value(edge)),))
                        lines.append(f"{name}_bucket{labels} {cumulative}")
                    labels = _render_labels(key, (("le", "+Inf"),))
                    lines.append(f"{name}_bucket{labels} {count}")
                    lines.append(f"{name}_sum{_render_labels(key)} {_fmt_value(total)}")
                    lines.append(f"{name}_count{_render_labels(key)} {count}")
            else:
                for key, value in sorted(inst.collect().items()):
                    lines.append(f"{name}{_render_labels(key)} {_fmt_value(value)}")
        return "\n".join(lines) + "\n" if lines else ""

    def emit(self, path: str, **extra: Any) -> Dict[str, Any]:
        """Append one full snapshot as a JSONL record through the shared writer."""
        record: Dict[str, Any] = {"what": "obs_registry", **extra, "registry": self.snapshot()}
        append_jsonl(path, record)
        return record

    # ------------------------------------------------------------------ lifecycle

    def clear_values(self) -> None:
        """Zero every recorded sample, keeping registered instruments (and any
        references subsystems hold to them) valid — the test-isolation hook."""
        with self._lock:
            instruments = list(self._instruments.values())
        for inst in instruments:
            inst.clear()


REGISTRY = Registry()
