"""Cluster-plane exception taxonomy (port of ``metrics_tpu/cluster/errors.py``).

Mirrors the repl plane's split: operator/config mistakes extend
:class:`~metrics_tpu_torch.utils.exceptions.MetricsTPUUserError` (actionable at
the call site), infrastructure failures extend :class:`RuntimeError`
(retryable, absorbed by the supervisor loop and surfaced through health
instead of killing it).
"""

from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

__all__ = ["ClusterConfigError", "CoordStoreError", "NoLeaderError"]


class ClusterConfigError(MetricsTPUUserError):
    """Invalid cluster wiring (bad ids, bad TTLs, mismatched stores)."""


class CoordStoreError(RuntimeError):
    """The coordination store could not be reached or its record was torn.

    Transient by contract: callers (the supervisor tick, the client router)
    back off and retry — a node partitioned from the store must behave
    exactly like a node whose lease expired, never crash."""


class NoLeaderError(MetricsTPUUserError):
    """The client router exhausted its retries without resolving a writable
    leader (no lease holder, or every redirect bounced). Retryable: a
    failover may be in flight — back off and call again."""
