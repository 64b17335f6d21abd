"""Process-global metrics registry and the master switch
(port of ``metrics_tpu/obs/registry.py``: the ``OBS`` gate and labelled counters).

Every instrumentation hook tests ``OBS.enabled`` (one attribute load) before
doing any work, so the disabled library does no telemetry work at all.
Stdlib only.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


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


class Registry:
    """Get-or-create by name, so independent subsystems share series."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(name, help)
            return self._counters[name]


REGISTRY = Registry()
