"""GuardConfig — every admission/overload/breaker/watchdog knob in one place.

One frozen dataclass, handed to ``StreamingEngine(guard=GuardConfig(...))``.
Every policy reads time through ``clock`` (default ``time.perf_counter``), so
tests drive the whole plane with a :class:`~metrics_tpu_torch.guard.faults.ManualClock`
and never sleep. ``GuardConfig()`` with no arguments enables the *safety*
features (fair drain, deadline expiry, shedding, breakers, quarantine) but no
quotas and no watchdog thread — quotas need a policy decision (what is a fair
rate?) and the watchdog needs a timeout calibrated to the deployment's kernel
latencies, so both are opt-in.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Hashable, Optional

__all__ = ["GuardConfig"]


@dataclass(frozen=True)
class GuardConfig:
    """Guard-plane wiring for one :class:`~metrics_tpu_torch.engine.StreamingEngine`.

    Admission (checked at ``submit`` entry, before any queue wait):

    - ``quota_rows_per_s`` / ``quota_burst_rows``: per-tenant token bucket on
      submitted *rows* (requests vary in size; rows are what occupy bucket
      slots). ``None`` disables quotas. ``tenant_quotas`` overrides the rate
      for specific tenants; rate 0 blocks a tenant outright (unless an
      explicit ``quota_burst_rows`` turns it into a fixed, non-replenishing
      allowance).

    Drain-time fairness (enforced when the dispatcher drains the queue — a
    tenant that got past admission still cannot monopolize micro-batch slots):

    - ``fair``: interleave the drained batch across tenants by weighted
      deficit round-robin (per-tenant submission order preserved).
    - ``tenant_weights``: relative shares (default 1.0 each).
    - ``drain_quantum_rows``: cap on rows dispatched per drain cycle; the
      remainder stays backlogged (and is what backpressure then prices).
      ``None`` defaults to ``8 × max bucket rows``.

    Deadlines + overload shedding:

    - ``submit(..., deadline=s)`` requests that expire in-queue fail fast with
      :class:`~metrics_tpu_torch.guard.errors.DeadlineExceeded`.
    - ``shed``: CoDel-style controller on queue sojourn time — when the
      *minimum* sojourn over ``shed_interval_s`` stays above ``shed_target_s``
      the engine is in standing overload, and requests with
      ``priority <= shed_max_priority`` are dropped at an increasing rate
      until sojourn recovers (:class:`~metrics_tpu_torch.guard.errors.RequestShed`).
      Submit with a higher priority to mark work never-shed.

    Circuit breakers (consecutive-failure trip, exponential probation
    ``probation_s × factor^k`` capped at ``probation_max_s``, half-open single
    probe):

    - ``compile_breaker``: token bucket on micro-batch graph-cache misses
      (``compile_rate_per_s``/``compile_burst``; each miss is one CUDA-graph
      capture, what a trace and compile is in the JAX package); an exhausted
      budget trips the breaker and novel-signature chunks run eagerly, on the
      engine's own device, instead of growing the graph cache (captured
      graphs keep serving).
    - ``ckpt_breaker``: repeated async-checkpoint failures suspend snapshot
      attempts for the probation instead of retrying every interval.
    - ``comm_breaker``: repeated degraded/stale comm syncs pin
      ``compute(sync=True)`` to local state for the probation.

    Poison-tenant quarantine: ``quarantine_threshold`` consecutive request
    *failures* (not rejections) quarantines the tenant with the same
    exponential-probation schedule (``quarantine_probation_s`` …).

    Watchdog: with ``watchdog_timeout_s`` set, a monitor thread polls every
    ``watchdog_poll_s`` and declares the dispatcher hung once it has been busy
    on one batch longer than the timeout. If the dispatch lock can be acquired
    within ``hang_lock_timeout_s`` the hang was outside the device path: the
    pending work is replayed inline (flush-correct, same ladder as a worker
    death) and — with ``restart=True`` and restarts remaining — a fresh
    dispatcher is started (health returns to ``SERVING``). If the lock cannot
    be acquired the worker is wedged inside a device call: replay would risk
    double-commit, so the engine quarantines itself and fails fast instead of
    hanging clients.
    """

    # deterministic time source for every policy below (perf_counter so the
    # engine can reuse its existing submit-entry stamp for sojourn tracking —
    # one fewer clock read per guarded submit)
    clock: Callable[[], float] = time.perf_counter

    # ---- per-tenant admission quotas
    quota_rows_per_s: Optional[float] = None
    quota_burst_rows: Optional[float] = None  # default: 2s of rate
    tenant_quotas: Dict[Hashable, float] = field(default_factory=dict)

    # ---- weighted fair micro-batch formation
    fair: bool = True
    tenant_weights: Dict[Hashable, float] = field(default_factory=dict)
    drain_quantum_rows: Optional[int] = None

    # ---- deadline expiry + CoDel-style shedding. The defaults tolerate
    # cold-start stalls: a first graph capture parks the dispatcher with
    # work queued, and shedding a user's warmup requests for
    # that is hostile — only sojourn above target for a FULL 1s interval is
    # standing overload. Latency-critical deployments tighten both.
    shed: bool = True
    shed_target_s: float = 0.1
    shed_interval_s: float = 1.0
    shed_max_priority: int = 0

    # ---- circuit breakers
    compile_breaker: bool = True
    compile_rate_per_s: float = 2.0
    compile_burst: float = 16.0
    ckpt_breaker: bool = True
    comm_breaker: bool = True
    breaker_failure_threshold: int = 3
    breaker_probation_s: float = 1.0
    breaker_probation_max_s: float = 60.0
    breaker_probation_factor: float = 2.0

    # ---- poison-tenant quarantine
    quarantine_threshold: int = 5
    quarantine_probation_s: float = 1.0
    quarantine_probation_max_s: float = 300.0
    quarantine_probation_factor: float = 2.0

    # ---- dispatch watchdog
    watchdog_timeout_s: Optional[float] = None
    watchdog_poll_s: float = 0.05
    hang_lock_timeout_s: float = 1.0
    restart: bool = True
    max_restarts: int = 3

    # ---- health-transition observer: called as ``hook(old_state, new_state)``
    # exactly once per observed SERVING/DEGRADED/QUARANTINED transition, outside
    # the engine's locks, exceptions absorbed. Every internal transition point
    # (worker death/hang takeover, quarantine, restart, close) publishes health,
    # so quarantine fires promptly; purely breaker-driven DEGRADED flips are
    # observed at the next health() read. The replication plane's failover
    # rides this: ``on_health_transition=repl.failover_hook(follower)`` promotes
    # the follower the moment the watchdog quarantines a wedged primary.
    on_health_transition: Optional[Callable[[str, str], None]] = None

    def __post_init__(self) -> None:
        if self.quota_rows_per_s is not None and self.quota_rows_per_s < 0:
            raise ValueError(f"`quota_rows_per_s` must be >= 0, got {self.quota_rows_per_s}")
        if self.shed_target_s <= 0 or self.shed_interval_s <= 0:
            raise ValueError("`shed_target_s` and `shed_interval_s` must be > 0")
        if self.breaker_failure_threshold < 1 or self.quarantine_threshold < 1:
            raise ValueError("failure thresholds must be >= 1")
        if self.drain_quantum_rows is not None and self.drain_quantum_rows < 1:
            raise ValueError(f"`drain_quantum_rows` must be >= 1, got {self.drain_quantum_rows}")
        for key, weight in self.tenant_weights.items():
            if weight <= 0:
                raise ValueError(
                    f"`tenant_weights[{key!r}]` must be > 0, got {weight} — a zero-ish "
                    "weight would make the fair scheduler spin to emit that tenant's "
                    "requests; to deprioritize, use a small positive weight, and to "
                    "block, use `tenant_quotas={key: 0}`"
                )
