"""Fault doubles for guard-plane testing: deterministic clocks, wedged and
killed dispatchers, poison request generators.

Complements the other planes' injectors (``comm.transport`` Flaky/Stall/
DeadPeer, ``ckpt.faults`` tear/flip_bit/DiskFull) with the failure modes the
guard plane exists to survive. ``chip_smoke.py`` Phase N3 drives the wedge,
the held lock and the capture governor on the card.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Iterator, Optional, Tuple

__all__ = [
    "ManualClock",
    "hold_dispatch_lock",
    "kill_dispatcher",
    "poison_args",
    "wedge_dispatcher",
]


class ManualClock:
    """A monotonic clock tests advance by hand — the zero-sleep time source
    every guard policy accepts via ``GuardConfig(clock=...)``."""

    def __init__(self, start: float = 0.0) -> None:
        self._now = float(start)
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            return self._now

    def advance(self, dt: float) -> float:
        with self._lock:
            self._now += float(dt)
            return self._now

    def set(self, t: float) -> float:
        with self._lock:
            self._now = float(t)
            return self._now


@contextmanager
def wedge_dispatcher(engine: Any) -> Iterator[None]:
    """Wedge the dispatcher *between* drain and processing (gate hook): the
    worker sits on a drained batch without holding the dispatch lock — the
    recoverable hang (watchdog replays inline and restarts). The gate reopens
    on exit so the superseded worker can observe its stale epoch and retire."""
    engine._worker_gate.clear()
    try:
        yield
    finally:
        engine._worker_gate.set()


@contextmanager
def hold_dispatch_lock(engine: Any) -> Iterator[None]:
    """Simulate a worker wedged *inside* a device call: the dispatch lock is
    held and cannot be taken over — the unrecoverable hang (engine
    quarantines itself rather than risk double-commit)."""
    engine._dispatch_lock.acquire()
    try:
        yield
    finally:
        engine._dispatch_lock.release()


def kill_dispatcher(engine: Any, exc: Optional[BaseException] = None) -> BaseException:
    """Arm a one-shot dispatcher crash: the next drained batch raises ``exc``
    inside the worker, triggering the worker-death ladder (inline replay, and
    a guard-managed restart when configured). Returns the armed exception."""
    boom = exc if exc is not None else RuntimeError("guard.faults: injected dispatcher crash")
    original = engine._process

    def exploding(batch: Any, *args: Any, **kwargs: Any) -> Any:
        engine._process = original  # one-shot: the replay/restart path runs clean
        raise boom

    engine._process = exploding
    return boom


def poison_args(rows: int = 2) -> Tuple[Any, Any]:
    """Arguments that pass admission (consistent leading axis) but fail inside
    any two-argument elementwise update: incompatible trailing shapes."""
    import numpy as np

    return np.zeros((rows, 3), np.float32), np.zeros((rows, 4), np.float32)
