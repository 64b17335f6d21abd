"""Process-global metrics registry and the master switch
(port of ``metrics_tpu/obs/registry.py``: the ``OBS`` gate, labelled counters
and histograms).

Every instrumentation hook tests ``OBS.enabled`` (one attribute load) before
doing any work, so the disabled library does no telemetry work at all.
Stdlib only.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Any, Dict, Iterable, List, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

# seconds-scale edges, 1 µs to 10 s (the JAX package's defaults)
DEFAULT_BUCKETS: Tuple[float, ...] = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)


class ObsGate:
    """The one master switch: a bare attribute, so the hot-path check is one load."""

    __slots__ = ("enabled",)

    def __init__(self) -> None:
        self.enabled = False


OBS = ObsGate()


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotone counter family, one value per label set."""

    def __init__(self, name: str, help: str) -> None:
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values: Dict[LabelKey, float] = {}

    def inc(self, n: float = 1, **labels: Any) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease (inc({n}))")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + n

    def value(self, **labels: Any) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0)

    def clear(self) -> None:
        with self._lock:
            self._values.clear()


class Histogram:
    """Bucketed distribution family: per label set, the count in each bucket
    (upper-inclusive edges and an implicit +Inf bucket), the sum and the count."""

    def __init__(self, name: str, help: str, buckets: Iterable[float] = DEFAULT_BUCKETS) -> None:
        self.name = name
        self.help = help
        self.edges: Tuple[float, ...] = tuple(sorted(float(b) for b in buckets))
        self._lock = threading.Lock()
        self._buckets: Dict[LabelKey, List[int]] = {}
        self._sums: Dict[LabelKey, float] = {}

    def observe(self, value: float, **labels: Any) -> None:
        v = float(value)
        key = _label_key(labels)
        with self._lock:
            row = self._buckets.setdefault(key, [0] * (len(self.edges) + 1))
            row[bisect_left(self.edges, v)] += 1
            self._sums[key] = self._sums.get(key, 0.0) + v

    def count(self, **labels: Any) -> int:
        with self._lock:
            return sum(self._buckets.get(_label_key(labels), ()))

    def sum(self, **labels: Any) -> float:
        with self._lock:
            return self._sums.get(_label_key(labels), 0.0)

    def clear(self) -> None:
        with self._lock:
            self._buckets.clear()
            self._sums.clear()


class Registry:
    """Get-or-create by name, so independent subsystems share series."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(name, help)
            return self._counters[name]

    def histogram(self, name: str, help: str = "") -> Histogram:
        with self._lock:
            if name not in self._histograms:
                self._histograms[name] = Histogram(name, help)
            return self._histograms[name]


REGISTRY = Registry()
