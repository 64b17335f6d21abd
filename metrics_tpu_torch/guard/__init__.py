"""metrics_tpu_torch.guard — admission control, overload shedding, circuit breakers
and the dispatch watchdog for the serving stack.

The engine's correctness planes (comm retry/degradation, ckpt crash recovery)
keep *faults* from becoming wrong answers; the guard plane keeps *overload and
abuse* from becoming everyone's latency. Wire it in with one argument::

    from metrics_tpu_torch.engine import StreamingEngine
    from metrics_tpu_torch.guard import GuardConfig

    engine = StreamingEngine(
        metric,
        guard=GuardConfig(
            quota_rows_per_s=10_000,     # per-tenant token-bucket admission
            watchdog_timeout_s=30.0,     # hung-dispatcher detection + restart
        ),
    )
    fut = engine.submit(key, preds, target, deadline=0.5, priority=1)
    engine.health()   # {"state": "SERVING", "breakers": {...}, ...}

Five mechanisms, one config (see :class:`~metrics_tpu_torch.guard.config.GuardConfig`
):

1. per-tenant token-bucket quotas + weighted fair micro-batch formation
   (fairness enforced at drain time, not just admission);
2. request deadlines + CoDel-style sojourn-time load shedding;
3. circuit breakers with half-open probes around graph captures, checkpoint
   commits, and comm sync;
4. poison-tenant quarantine with exponential probation;
5. a dispatch watchdog driving the SERVING → DEGRADED → QUARANTINED health
   state machine (``engine.health()`` + master-gated obs gauges).

Every policy takes an injectable clock (deterministic tests, no sleeps);
fault doubles live in :mod:`metrics_tpu_torch.guard.faults`.
"""

from metrics_tpu_torch.guard.breaker import BREAKER_STATE_CODES, CircuitBreaker, CompileGovernor
from metrics_tpu_torch.guard.config import GuardConfig
from metrics_tpu_torch.guard.errors import (
    DeadlineExceeded,
    EngineQuarantined,
    GuardRejected,
    QuotaExceeded,
    RequestShed,
    TenantQuarantined,
)
from metrics_tpu_torch.guard.fairness import FairBacklog, FifoBacklog, fair_order
from metrics_tpu_torch.guard.plane import GuardPlane
from metrics_tpu_torch.guard.quarantine import TenantQuarantine
from metrics_tpu_torch.guard.quota import TenantQuotas, TokenBucket
from metrics_tpu_torch.guard.shed import CoDelShedder
from metrics_tpu_torch.guard.watchdog import HangDetector, Watchdog

__all__ = [
    "BREAKER_STATE_CODES",
    "CircuitBreaker",
    "CoDelShedder",
    "CompileGovernor",
    "DeadlineExceeded",
    "EngineQuarantined",
    "FairBacklog",
    "fair_order",
    "FifoBacklog",
    "GuardConfig",
    "GuardPlane",
    "GuardRejected",
    "HangDetector",
    "QuotaExceeded",
    "RequestShed",
    "TenantQuarantine",
    "TenantQuotas",
    "TokenBucket",
    "Watchdog",
]
