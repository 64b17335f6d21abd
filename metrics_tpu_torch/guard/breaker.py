"""Circuit breakers with half-open probes and exponential probation.

The classic three-state machine::

                 failure_threshold consecutive failures
        CLOSED ────────────────────────────────────────► OPEN
          ▲                                               │ probation elapses
          │ probe succeeds                                ▼
          └────────────────────────────────────────── HALF_OPEN
                                                          │ probe fails
                                                          └──► OPEN (probation × factor)

- ``permit()`` is the gate callers check before touching the protected
  dependency. CLOSED always permits; OPEN permits nothing until the probation
  expires, at which point the breaker moves to HALF_OPEN and permits exactly
  ONE probe; further ``permit()`` calls are refused until that probe resolves
  via ``record_success``/``record_failure`` (or ``abandon_probe`` if the
  caller never actually attempted it).
- probation grows exponentially with consecutive trips —
  ``probation_s × factor^(trips-1)``, capped at ``probation_max_s`` — and a
  recorded success resets both the failure streak and the trip ladder.

:class:`CompileGovernor` specialises the breaker for the graph-capture
dependency (in the port a micro-batch graph-cache miss is one CUDA-graph
capture, what a compile is in the JAX package): the *failure* there is not an
exception but an exhausted capture budget (a token bucket on cache misses).
While the budget holds, captures pass and the breaker stays closed; a miss with an empty bucket counts
as a failure, and a tripped breaker routes novel-signature chunks to eager
execution until a half-open probe finds budget again.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from metrics_tpu_torch.guard.quota import TokenBucket

__all__ = ["BREAKER_STATE_CODES", "CircuitBreaker", "CompileGovernor"]

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"

# gauge encoding for the guard's breaker-state gauge (obs.instrument)
BREAKER_STATE_CODES: Dict[str, int] = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """Thread-safe breaker; all timing through the injected clock."""

    def __init__(
        self,
        name: str,
        *,
        failure_threshold: int = 3,
        probation_s: float = 1.0,
        probation_max_s: float = 60.0,
        probation_factor: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable[[str, str, str], None]] = None,
    ) -> None:
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.probation_s = float(probation_s)
        self.probation_max_s = float(probation_max_s)
        self.probation_factor = float(probation_factor)
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._trips = 0  # consecutive trips without an intervening success
        self._open_until = 0.0
        self._probe_inflight = False

    # ------------------------------------------------------------------ internals

    def _probation(self) -> float:
        return min(
            self.probation_max_s,
            self.probation_s * self.probation_factor ** max(0, self._trips - 1),
        )

    def _transition(self, new: str) -> None:
        old, self._state = self._state, new
        if old != new and self._on_transition is not None:
            try:
                self._on_transition(self.name, old, new)
            except Exception:  # noqa: BLE001 — observability must not break the policy
                pass

    # ------------------------------------------------------------------ public API

    @property
    def state(self) -> str:
        with self._lock:
            if self._state == OPEN and self._clock() >= self._open_until:
                return HALF_OPEN  # what permit() would find
            return self._state

    def permit(self) -> bool:
        """May the caller touch the protected dependency right now?"""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() < self._open_until:
                    return False
                self._transition(HALF_OPEN)
                self._probe_inflight = True
                return True
            # HALF_OPEN: exactly one probe at a time
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def abandon_probe(self) -> None:
        """The permitted probe was never actually attempted — free the slot."""
        with self._lock:
            self._probe_inflight = False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._trips = 0
            self._probe_inflight = False
            if self._state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            now = self._clock()
            if self._state == HALF_OPEN or (self._state == OPEN and now >= self._open_until):
                # failed probe (or failure observed right as probation lapsed)
                self._trips += 1
                self._probe_inflight = False
                self._open_until = now + self._probation()
                self._transition(OPEN)
                return
            if self._state == OPEN:
                return  # already open; the probation clock is authoritative
            self._consecutive += 1
            if self._consecutive >= self.failure_threshold:
                self._trips += 1
                self._open_until = now + self._probation()
                self._transition(OPEN)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            state = self._state
            if state == OPEN and self._clock() >= self._open_until:
                state = HALF_OPEN
            return {
                "state": state,
                "consecutive_failures": self._consecutive,
                "trips": self._trips,
                "open_until": self._open_until if state == OPEN else None,
            }


class CompileGovernor:
    """Token-bucket compile budget behind a :class:`CircuitBreaker`.

    ``allow_compile()`` is consulted on every graph-cache miss. Within budget
    the capture proceeds (and closes the breaker). Past budget the miss is a
    breaker failure; once tripped, every novel signature is refused for the
    probation — the caller routes those chunks to eager execution on the same
    device, so a tenant spraying novel shapes pays with its own latency
    instead of everyone's capture storms. Captured graphs are never governed
    (no miss, no check). The names keep the JAX package's, so configurations
    and telemetry read the same in both packages.
    """

    def __init__(self, rate_per_s: float, burst: float, breaker: CircuitBreaker) -> None:
        self.breaker = breaker
        self.bucket = TokenBucket(rate_per_s, burst, breaker._clock)

    def allow_compile(self) -> bool:
        if not self.breaker.permit():
            return False
        if self.bucket.try_take(1.0):
            self.breaker.record_success()
            return True
        self.breaker.record_failure()
        return False
