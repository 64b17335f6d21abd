"""Dispatch watchdog: detect a hung worker and hand the decision to the engine.

Split for testability:

- :class:`HangDetector` is the pure policy — "has the dispatcher been busy on
  one batch longer than ``timeout_s``?" — fed by ``busy_since`` marks from the
  engine and read with an injected clock, so every detection scenario is a
  deterministic unit test.
- :class:`Watchdog` is the thin monitor thread: poll the probe, fire
  ``on_hang`` once per detection (the engine's hang handler supersedes the
  worker, so the same hang never fires twice), swallow nothing silently — a
  probe/handler crash is recorded on ``last_error``.

What "hung" means and what happens next (the lock-probe split between inline
replay + restart vs engine quarantine) is the engine's call — see
``StreamingEngine._on_worker_hang``. On the card a replaying CUDA graph cannot
be interrupted, so the lock probe is what tells the two cases apart.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, Iterator, Optional

__all__ = ["HangDetector", "Watchdog"]


class HangDetector:
    """Busy-too-long policy over engine-provided marks (injectable clock)."""

    def __init__(self, timeout_s: float, clock: Callable[[], float] = time.monotonic) -> None:
        self.timeout_s = float(timeout_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._busy_since: Optional[float] = None
        self._stretch: Optional[Callable[[], int]] = None

    def mark_busy(self) -> None:
        """The dispatcher took ownership of a batch (called at drain)."""
        with self._lock:
            if self._busy_since is None:
                self._busy_since = self._clock()

    def mark_idle(self) -> None:
        """The batch (and its follow-up work) finished."""
        with self._lock:
            self._busy_since = None

    @contextmanager
    def stretched(self, factor: Callable[[], int]) -> Iterator[None]:
        """Inside the block the deadline is ``timeout_s × factor()``, read at each
        probe; the clock keeps running. On leaving it a busy clock starts afresh,
        so the work after the block gets the plain ``timeout_s``."""
        with self._lock:
            self._stretch = factor
        try:
            yield
        finally:
            with self._lock:
                self._stretch = None
                if self._busy_since is not None:
                    self._busy_since = self._clock()

    def hung(self, now: Optional[float] = None) -> bool:
        with self._lock:
            if self._busy_since is None:
                return False
            limit = self.timeout_s * (max(1, self._stretch()) if self._stretch is not None else 1)
            return ((self._clock() if now is None else now) - self._busy_since) > limit


class Watchdog:
    """Daemon thread: ``probe()`` every ``poll_s``; fire ``on_hang()`` on True."""

    def __init__(
        self,
        probe: Callable[[], bool],
        on_hang: Callable[[], None],
        *,
        poll_s: float = 0.05,
        name: str = "metrics-tpu-guard-watchdog",
    ) -> None:
        self._probe = probe
        self._on_hang = on_hang
        self._poll_s = float(poll_s)
        self._stop = threading.Event()
        self.last_error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            try:
                if self._probe():
                    self._on_hang()
            except Exception as exc:  # noqa: BLE001 — the monitor must outlive its probe
                self.last_error = exc

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=timeout)
