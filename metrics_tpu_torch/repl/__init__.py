"""Replication plane — WAL shipping, follower replay, bounded-staleness reads,
hot failover (port of ``metrics_tpu/repl``).

The sixth plane of the serving stack, built entirely on the artifacts the
others already produce: the ckpt plane's atomic snapshots + CRC-framed
seq-numbered WAL are the replication log, the engine's recovery machinery is
the replayer, and the guard plane's health transitions are the failover
trigger. Topology is one primary (owns the write path and the durable
lineage) plus ONE read replica per ship link — every transport here is a
single-consumer stream (``recv`` consumes), so two followers must never share
a link; a primary reaches N followers by wiring a
:class:`~metrics_tpu_torch.repl.transport.FanoutTransport` over N single-consumer
links — the fan-out happens at the transport layer, not in the engine::

    from metrics_tpu_torch.engine import CheckpointConfig, ReplConfig, StreamingEngine
    from metrics_tpu_torch.repl import LoopbackLink

    link = LoopbackLink()
    primary = StreamingEngine(
        metric,
        checkpoint=CheckpointConfig(directory="/data/primary"),
        replication=ReplConfig(role="primary", transport=link),
    )
    follower = StreamingEngine(
        metric,
        replication=ReplConfig(
            role="follower", transport=link, max_staleness_s=2.0,
            promote_checkpoint=CheckpointConfig(directory="/data/follower"),
        ),
    )
    follower.compute(key)          # read replica: refused beyond max_staleness
    follower.replica_lag()         # ReplicaLag(seqs_behind, seconds_behind)
    follower.promote()             # hot failover: drain, fence, go writable

Failover wires through the guard plane's health-transition hook — when the
watchdog quarantines a wedged primary, the follower promotes itself::

    primary = StreamingEngine(..., guard=GuardConfig(
        watchdog_timeout_s=1.0, on_health_transition=failover_hook(follower)))

Fencing: promotion adopts ``deposed epoch + 1`` and fences the transport, so a
zombie primary's late shipments are rejected at the transport boundary and can
never leak into the promoted lineage.

Frames carry MTCKPT1 snapshot bytes and WAL records in the JAX package's
layouts, so a port follower bootstraps from and tracks a JAX primary (a
:class:`DirectoryTransport` spool of either package reads in the other).
"""

from metrics_tpu_torch.repl.config import ReplConfig, ReplicaLag
from metrics_tpu_torch.repl.errors import (
    FencedError,
    NotPrimaryError,
    NotPromotableError,
    ReplPeerLostError,
    ReplTransportError,
    StalenessExceeded,
)
from metrics_tpu_torch.repl.replica import ReplicaApplier
from metrics_tpu_torch.repl.shipper import Shipper
from metrics_tpu_torch.repl.transport import (
    DeadPeerLink,
    DirectoryTransport,
    FanoutTransport,
    FlakyLink,
    HeartbeatFrame,
    LoopbackLink,
    ReplTransport,
    ShipFrame,
    SnapshotFrame,
    SocketShipReceiver,
    SocketShipSender,
    StallLink,
    WalFrame,
)

__all__ = [
    "DeadPeerLink",
    "DirectoryTransport",
    "FanoutTransport",
    "FencedError",
    "FlakyLink",
    "HeartbeatFrame",
    "LoopbackLink",
    "NotPrimaryError",
    "NotPromotableError",
    "ReplConfig",
    "ReplPeerLostError",
    "ReplTransport",
    "ReplTransportError",
    "ReplicaApplier",
    "ReplicaLag",
    "ShipFrame",
    "Shipper",
    "SnapshotFrame",
    "SocketShipReceiver",
    "SocketShipSender",
    "StalenessExceeded",
    "StallLink",
    "WalFrame",
    "failover_hook",
]


def failover_hook(
    follower_engine,
    *,
    on_state: str = "QUARANTINED",
    retries: int = 20,
    backoff_s: float = 0.05,
    backoff_cap_s: float = 1.0,
):
    """Build a ``GuardConfig(on_health_transition=...)`` observer that promotes
    ``follower_engine`` the moment the primary's health reaches ``on_state``.

    The guard fires the hook outside its locks and absorbs exceptions, and the
    two engines share no locks, so the promotion runs inline — by the time the
    quarantined primary's callers see their failures, the follower is already
    writable.

    :class:`~metrics_tpu_torch.repl.errors.NotPromotableError` is retryable by
    contract: the follower merely hasn't received its bootstrap snapshot yet
    (the primary may have died mid-ship). The hook backs off with capped
    exponential delays and retries up to ``retries`` times — if the snapshot
    never lands, it gives up quietly and leaves the follower read-only (the
    guard absorbs hook exceptions anyway; raising would change nothing).
    """
    import time as _time

    def _hook(old: str, new: str) -> None:
        if new != on_state or old == on_state:
            return
        for attempt in range(retries + 1):
            try:
                follower_engine.promote()
                return
            except NotPromotableError:
                if attempt == retries:
                    return
                _time.sleep(min(backoff_s * (2.0 ** attempt), backoff_cap_s))

    return _hook
