"""ReplConfig + ReplicaLag — the replication plane's wiring and staleness bound
(port of ``metrics_tpu/repl/config.py``, the same fields, defaults and messages).

One frozen dataclass handed to ``StreamingEngine(replication=ReplConfig(...))``.
Role ``"primary"`` attaches a background :class:`~metrics_tpu_torch.repl.shipper.Shipper`
(requires the durable state plane: ``checkpoint=CheckpointConfig(..., wal=True)``
is what produces the snapshot + WAL lineage the shipper publishes). Role
``"follower"`` makes the engine a read replica: it bootstraps from a shipped
snapshot, continuously replays shipped WAL records, refuses writes with
:class:`~metrics_tpu_torch.repl.errors.NotPrimaryError`, and refuses reads whose
:class:`ReplicaLag` exceeds the configured ``max_staleness`` bound.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

__all__ = ["ReplConfig", "ReplicaLag"]

_ROLES = ("primary", "follower")


@dataclass(frozen=True)
class ReplicaLag:
    """How far behind the primary a follower's applied state is.

    - ``seqs_behind``: WAL records known shipped/journaled but not yet applied
      here (0 = caught up with everything this replica has heard of).
    - ``seconds_behind``: age of the replica's view — the replica's OWN
      monotonic time since it last learned it was current (``inf`` before
      bootstrap / before anything was heard). Never a cross-host wall-clock
      difference, so clock skew cannot under-report staleness; the only
      optimism is one link transit time. Heartbeats keep it near the
      heartbeat interval on an idle stream; a dead link makes it grow — the
      conservative reading a bounded-staleness contract needs.
    """

    seqs_behind: int
    seconds_behind: float

    def exceeds(self, max_seqs: Optional[int], max_seconds: Optional[float]) -> bool:
        if max_seqs is not None and self.seqs_behind > max_seqs:
            return True
        if max_seconds is not None and self.seconds_behind > max_seconds:
            return True
        return False


@dataclass(frozen=True)
class ReplConfig:
    """Replication wiring for one :class:`~metrics_tpu_torch.engine.StreamingEngine`.

    Args:
        role: ``"primary"`` (ship) or ``"follower"`` (replay + read-only serve).
        transport: the :class:`~metrics_tpu_torch.repl.transport.ReplTransport` frames
            travel over. The primary sends on it; the follower receives.
        ship_interval_s: primary ship-loop tick — how often new WAL tail records
            are published (the floor on follower lag under steady traffic).
        poll_interval_s: follower receive-loop tick.
        heartbeat_interval_s: primary liveness/position frames on an idle
            stream, so a caught-up follower's ``seconds_behind`` stays bounded.
        max_staleness_seqs / max_staleness_s: the read contract — a follower
            read whose :class:`ReplicaLag` exceeds either bound is refused with
            :class:`~metrics_tpu_torch.repl.errors.StalenessExceeded`. ``None`` = no
            bound on that axis (both ``None`` = always serve, tagged with lag).
        epoch: this node's starting fencing token. A promoted follower adopts
            ``deposed primary's epoch + 1`` and fences the transport at it; a
            restarted promoted primary recovers its token from snapshot meta.
            Standing up a REPLACEMENT primary on a fresh directory requires
            bumping ``epoch`` past the old one's: the higher epoch tells
            followers the seq numbering restarted (they re-bootstrap instead
            of dropping the new lineage's records as duplicates).
        promote_checkpoint: the :class:`~metrics_tpu_torch.engine.CheckpointConfig`
            lineage a promoted follower re-opens as its OWN durable state plane
            (fresh directory — never the deposed primary's). ``None`` leaves a
            promoted node serving without durability (warned).
        drain_timeout_s: how long a promotion waits for the shipped tail to
            drain out of the transport before fencing.
    """

    role: str
    transport: Any
    ship_interval_s: float = 0.05
    poll_interval_s: float = 0.05
    heartbeat_interval_s: float = 1.0
    max_staleness_seqs: Optional[int] = None
    max_staleness_s: Optional[float] = None
    epoch: int = 0
    promote_checkpoint: Optional[Any] = None  # engine CheckpointConfig
    drain_timeout_s: float = 5.0

    def __post_init__(self) -> None:
        if self.role not in _ROLES:
            raise ValueError(f"`role` must be one of {_ROLES}, got {self.role!r}")
        if self.transport is None:
            raise ValueError("`transport` is required (e.g. repl.LoopbackLink())")
        if self.ship_interval_s <= 0 or self.poll_interval_s <= 0:
            raise ValueError("`ship_interval_s` and `poll_interval_s` must be > 0")
        if self.heartbeat_interval_s <= 0:
            raise ValueError(f"`heartbeat_interval_s` must be > 0, got {self.heartbeat_interval_s}")
        if self.drain_timeout_s < 0:
            raise ValueError(f"`drain_timeout_s` must be >= 0, got {self.drain_timeout_s}")
        if self.max_staleness_seqs is not None and self.max_staleness_seqs < 0:
            raise ValueError(f"`max_staleness_seqs` must be >= 0, got {self.max_staleness_seqs}")
        if self.max_staleness_s is not None and self.max_staleness_s < 0:
            raise ValueError(f"`max_staleness_s` must be >= 0, got {self.max_staleness_s}")
        if self.epoch < 0:
            raise ValueError(f"`epoch` must be >= 0, got {self.epoch}")
