"""CoDel-style overload shedding on queue sojourn time.

Queue *length* is the wrong overload signal for a micro-batching engine — a
deep queue that drains in one dispatch is healthy. Sojourn time (how long the
oldest work has actually waited) is the signal CoDel built on, and the same
two-phase logic applies here, adapted from per-packet dequeue to per-drain
batches:

- **standing overload detection**: the controller tracks the *minimum* sojourn
  seen at each drain. A single slow drain (a graph capture, a capacity growth) spikes
  sojourn transiently; only a minimum that stays above ``target_s`` for a full
  ``interval_s`` is standing overload.
- **escalating shed**: once in the dropping state, each further overloaded
  drain sheds one more request than the last (1, 2, 3, …) until the minimum
  sojourn falls back under target, which exits the state and resets the
  escalation. Victims are chosen by the caller (the guard plane sheds the
  oldest low-priority requests — they have already blown the target).

Deterministic: all time flows through the injected clock; tests drive the
state machine directly with a :class:`~metrics_tpu_torch.guard.faults.ManualClock`.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

__all__ = ["CoDelShedder"]


class CoDelShedder:
    """Two-state (normal → dropping) sojourn-time controller."""

    def __init__(
        self,
        target_s: float = 0.1,
        interval_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.target_s = float(target_s)
        self.interval_s = float(interval_s)
        self._clock = clock
        self._first_above: Optional[float] = None  # when the interval timer expires
        self.dropping = False
        self.drop_count = 0

    def on_drain(self, min_sojourn_s: float, now: Optional[float] = None) -> int:
        """One drain observed ``min_sojourn_s``; returns how many requests to shed."""
        now = self._clock() if now is None else now
        if min_sojourn_s < self.target_s:
            # recovered: leave dropping, forget the interval timer and escalation
            self._first_above = None
            self.dropping = False
            self.drop_count = 0
            return 0
        if self._first_above is None:
            self._first_above = now + self.interval_s
            return 0
        if not self.dropping and now < self._first_above:
            return 0  # above target, but not yet for a full interval
        self.dropping = True
        self.drop_count += 1
        return self.drop_count
