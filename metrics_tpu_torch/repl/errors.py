"""Replication-plane failure vocabulary (port of ``metrics_tpu/repl/errors.py``).

Two families, split by who should catch them:

- **User errors** (:class:`NotPrimaryError`, :class:`StalenessExceeded`) extend
  :class:`~metrics_tpu_torch.utils.exceptions.MetricsTPUUserError` — a caller hit a
  role or staleness contract and should route the request elsewhere (writes to
  the primary, stale-intolerant reads to a fresher replica).
- **Transport errors** (:class:`ReplTransportError`, :class:`FencedError`,
  :class:`ReplPeerLostError`) are the shipper/applier's internal weather: the
  ship loop absorbs and retries them, except :class:`FencedError`, which is
  terminal — a fenced sender is a deposed primary and can never ship again.
"""

from __future__ import annotations

from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

__all__ = [
    "FencedError",
    "NotPrimaryError",
    "NotPromotableError",
    "ReplPeerLostError",
    "ReplTransportError",
    "StalenessExceeded",
]


class NotPrimaryError(MetricsTPUUserError):
    """A write (``submit``/``reset``/``rotate_window``) on a follower replica.

    Followers are read-only until :meth:`~metrics_tpu_torch.engine.StreamingEngine.promote`
    flips them; route writes to the primary."""


class StalenessExceeded(MetricsTPUUserError):
    """A follower read was refused because its :class:`~metrics_tpu_torch.repl.ReplicaLag`
    exceeded the configured ``max_staleness`` bound (or the replica has not
    bootstrapped yet, i.e. its staleness is unbounded)."""


class NotPromotableError(MetricsTPUUserError):
    """``promote()`` refused because this follower cannot safely become primary
    *yet*: it never received its bootstrap snapshot, so flipping it writable
    would pin fresh-init state as the authoritative lineage. Retryable by
    contract — automation (the guard failover hook)
    backs off and retries once a snapshot lands, instead of pattern-matching a
    generic error."""


class ReplTransportError(RuntimeError):
    """A ship/receive operation failed for a reason worth retrying next tick."""


class ReplPeerLostError(ReplTransportError):
    """The peer is gone for good — retrying the same link cannot succeed."""


class FencedError(ReplTransportError):
    """A frame carried an epoch below the transport's fence: the sender was
    deposed by a promotion and its shipments are permanently rejected."""
