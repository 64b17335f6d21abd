"""Cluster control plane — lease-based leadership, failure detection, and
self-driving failover (port of ``metrics_tpu/cluster``).

The ninth plane of the serving stack turns the repl plane's *reactive*
machinery (``promote()``, epoch fencing, the guard failover hook) into a
*self-driving* system: a tiny coordination store (CAS-with-TTL leases +
membership heartbeats) elects at most one writable leader, a per-node
supervisor detects silent peer death, and failover runs end-to-end with no
human in the loop — the lease expires, the healthiest bootstrapped follower
wins the CAS, promotes at exactly the lease epoch (so the dead leader's late
shipments are fenced at the transport boundary), re-ships its new lineage to
the survivors, and the revived old leader rejoins as a read-only follower::

    from metrics_tpu_torch.cluster import ClusterClient, ClusterConfig, ClusterNode, DirectoryCoordStore
    from metrics_tpu_torch.repl import DirectoryTransport

    store = DirectoryCoordStore("/shared/coord")
    link = lambda src, dst: DirectoryTransport(f"/shared/links/{src}-{dst}")
    node = ClusterNode(engine, ClusterConfig(
        node_id="a", peers=("b", "c"), store=store, link_factory=link))

    client = ClusterClient(store, {"a": eng_a, "b": eng_b, "c": eng_c})
    client.submit(key, preds, target)      # routed to the leader, wherever it is
    client.compute(key, prefer="replica")  # read scale-out with leader fallback

Safety lives at the boundary, not in the scheduler: the lease epoch IS the
repl fencing epoch, so losing the lease is losing the ability to write into
the lineage. The planes are host code: they supervise the engines they are
given, on whatever device those run. The coordination records and their
directory layout are the JAX package's, byte for byte, so one store directory
serves nodes of either package.
"""

from metrics_tpu_torch.cluster.client import ClusterClient
from metrics_tpu_torch.cluster.config import ClusterConfig
from metrics_tpu_torch.cluster.errors import ClusterConfigError, CoordStoreError, NoLeaderError
from metrics_tpu_torch.cluster.node import ClusterNode
from metrics_tpu_torch.cluster.store import (
    CoordStore,
    DirectoryCoordStore,
    FakeCoordStore,
    Lease,
    ManualClock,
    Member,
)

__all__ = [
    "ClusterClient",
    "ClusterConfig",
    "ClusterConfigError",
    "ClusterNode",
    "CoordStore",
    "CoordStoreError",
    "DirectoryCoordStore",
    "FakeCoordStore",
    "Lease",
    "ManualClock",
    "Member",
    "NoLeaderError",
]
