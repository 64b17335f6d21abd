"""ClusterConfig — one node's wiring into the cluster control plane (port of
``metrics_tpu/cluster/config.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping, Optional, Sequence

from metrics_tpu_torch.cluster.errors import ClusterConfigError
from metrics_tpu_torch.cluster.store import CoordStore

__all__ = ["ClusterConfig"]


@dataclass(frozen=True)
class ClusterConfig:
    """Wiring for one :class:`~metrics_tpu_torch.cluster.node.ClusterNode`.

    ``node_id``/``peers`` name the full membership (ids must be stable across
    restarts — they key the membership records and the replication links).
    ``link_factory(src, dst)`` returns the one-way repl transport the node
    named ``src`` ships to the node named ``dst`` over; both ends call it with
    the same pair and must get the same underlying channel (e.g. a
    ``DirectoryTransport`` on a shared spool directory). ``None`` disables
    replication orchestration (membership + leases only — a single-node
    cluster, or an externally wired topology).

    Timing knobs are in STORE-clock seconds (see ``CoordStore.now()``):

    - ``lease_ttl_s`` — leadership grant length; the leader renews at half
      TTL, and failover detection is bounded below by this.
    - ``heartbeat_interval_s`` — membership publish cadence.
    - ``suspect_after_s`` / ``confirm_after_s`` — heartbeat silence before a
      peer is *suspected* (counted, surfaced in health) and before it is
      *confirmed* dead (excluded from election candidacy).
    - ``tick_interval_s`` — the supervisor thread's real-time cadence
      (irrelevant under manual ticking in tests).
    - ``election_backoff_s`` / ``backoff_cap_s`` — jittered exponential
      backoff base/cap for promote retries and non-favourite candidacy.

    ``comm_view`` / ``peer_ranks`` wire the comm plane's membership signal
    into failure detection: pass the transport's
    :class:`~metrics_tpu_torch.comm.membership.WorldView` (``comm.view_for(t)``)
    plus the peer-id → comm-rank mapping, and every *attributed* collective
    failure against a peer counts as a suspicion edge — typically seconds
    ahead of heartbeat silence, since a sync fails the moment a peer stalls
    while heartbeats must first go quiet for ``suspect_after_s``.
    """

    node_id: str
    store: CoordStore
    peers: Sequence[str] = ()
    link_factory: Optional[Callable[[str, str], object]] = None
    lease_ttl_s: float = 3.0
    heartbeat_interval_s: float = 1.0
    suspect_after_s: float = 2.5
    confirm_after_s: float = 6.0
    tick_interval_s: float = 0.25
    election_backoff_s: float = 0.25
    backoff_cap_s: float = 2.0
    drain_timeout_s: float = 5.0
    rng_seed: Optional[int] = None
    on_transition: Optional[Callable[[str, str], None]] = None
    comm_view: Optional[object] = None  # a metrics_tpu_torch.comm WorldView (duck-typed)
    peer_ranks: Mapping[str, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.node_id:
            raise ClusterConfigError("node_id must be a non-empty string")
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
        if self.comm_view is not None and not self.peer_ranks:
            raise ClusterConfigError("comm_view requires peer_ranks (peer id -> comm rank)")
        unknown = [p for p in self.peer_ranks if p != self.node_id and p not in self.peers]
        if unknown:
            raise ClusterConfigError(f"peer_ranks names unknown peers: {unknown}")
