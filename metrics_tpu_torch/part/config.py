"""PartConfig — one node's wiring into the partition plane (port of
``metrics_tpu/part/config.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from metrics_tpu_torch.cluster.errors import ClusterConfigError
from metrics_tpu_torch.cluster.store import CoordStore
from metrics_tpu_torch.shard.ring import DEFAULT_VNODES

__all__ = ["PartConfig"]


@dataclass(frozen=True)
class PartConfig:
    """Wiring for one :class:`~metrics_tpu_torch.part.node.PartitionedNode`.

    The single-lease :class:`~metrics_tpu_torch.cluster.ClusterConfig` contract,
    generalised to ``partitions`` independent leaderships:

    - ``partitions`` / ``vnodes`` / ``seed`` parameterize the tenant →
      partition ring (``PartitionMap``) and MUST be stable across restarts of
      the same deployment (the partition manifest enforces this).
    - ``link_factory(src, dst, partition)`` returns the one-way repl
      transport node ``src`` ships partition ``partition``'s lineage to node
      ``dst`` over — one channel per (pair, partition), so fencing partition
      ``p3``'s link never touches ``p5``'s. ``None`` disables replication
      orchestration (leases + membership only).
    - ``manifest_directory`` pins the partition map on disk (migrations
      commit their routing here); ``None`` keeps it in-memory.

    Timing knobs are identical to ``ClusterConfig`` (store-clock seconds) and
    apply per partition: every named lease has ``lease_ttl_s``, renewals
    happen at half TTL, and election backoff gates each partition's candidacy
    independently. ``on_transition(partition, old_role, new_role)`` observes
    every per-partition role change.
    """

    node_id: str
    store: CoordStore
    partitions: int = 8
    peers: Sequence[str] = ()
    link_factory: Optional[Callable[[str, str, str], object]] = None
    vnodes: int = DEFAULT_VNODES
    seed: int = 0
    manifest_directory: Optional[str] = None
    lease_ttl_s: float = 3.0
    heartbeat_interval_s: float = 1.0
    suspect_after_s: float = 2.5
    confirm_after_s: float = 6.0
    tick_interval_s: float = 0.25
    election_backoff_s: float = 0.25
    backoff_cap_s: float = 2.0
    drain_timeout_s: float = 5.0
    rng_seed: Optional[int] = None
    on_transition: Optional[Callable[[str, str, str], None]] = None

    def __post_init__(self) -> None:
        if not self.node_id:
            raise ClusterConfigError("node_id must be a non-empty string")
        if self.partitions < 1:
            raise ClusterConfigError(f"partitions must be >= 1, got {self.partitions}")
        if self.node_id in self.peers:
            raise ClusterConfigError(f"peers must not include the node itself ({self.node_id!r})")
        if len(set(self.peers)) != len(self.peers):
            raise ClusterConfigError(f"duplicate peer ids: {list(self.peers)}")
        if self.lease_ttl_s <= 0:
            raise ClusterConfigError(f"lease_ttl_s must be > 0, got {self.lease_ttl_s}")
        if self.suspect_after_s > self.confirm_after_s:
            raise ClusterConfigError(
                f"suspect_after_s ({self.suspect_after_s}) must not exceed "
                f"confirm_after_s ({self.confirm_after_s})"
            )
