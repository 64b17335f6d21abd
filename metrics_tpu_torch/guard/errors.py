"""Guard-plane rejections: every fail-fast path gets a distinct, catchable type.

All of these are *admission* or *policy* outcomes, not bugs: the engine is
telling the caller "not this request, not now" in bounded time instead of
letting overload turn into unbounded latency. They subclass
:class:`~metrics_tpu_torch.utils.exceptions.MetricsTPUUserError` so a catch-all for
library-user errors keeps working, with :class:`GuardRejected` as the common
base for "the guard plane refused this request".
"""

from __future__ import annotations

from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

__all__ = [
    "DeadlineExceeded",
    "EngineQuarantined",
    "GuardRejected",
    "QuotaExceeded",
    "RequestShed",
    "TenantQuarantined",
]


class GuardRejected(MetricsTPUUserError):
    """Base: the guard plane refused this request (fail-fast, state untouched)."""


class QuotaExceeded(GuardRejected):
    """The tenant's token bucket is empty — it exceeded its admitted row rate."""


class DeadlineExceeded(GuardRejected):
    """The request's deadline expired while it waited in the queue (or had
    already expired at submit) — failed fast without occupying a batch slot."""


class RequestShed(GuardRejected):
    """Dropped by the overload controller: queue sojourn time stayed above
    target for a full interval, and this request's priority made it sheddable."""


class TenantQuarantined(GuardRejected):
    """The tenant's requests failed repeatedly; it is serving a probation
    period and fails fast instead of paying the per-request retry cost."""


class EngineQuarantined(GuardRejected):
    """The engine itself cannot serve safely (a dispatch worker is hung inside
    a device call and cannot be superseded) — requests fail fast instead of
    hanging the caller."""
