"""PartitionedClient — tenant-routed writes across a partitioned cluster (port
of ``metrics_tpu/part/client.py``).

Routing is two lookups deep: the :class:`~metrics_tpu_torch.part.pmap.PartitionMap`
answers *which partition* owns a tenant (seeded ring + migration overrides),
and the partition's *named lease* answers *which node* leads that partition.
The second lookup is exactly the cluster plane's routing contract, so this
client composes one :class:`~metrics_tpu_torch.cluster.client.ClusterClient` router
per partition, each scoped to its partition's named lease through a
``_LeaseView`` store adapter. Each router keeps its own leader cache, lease-
epoch memo, and capped jittered backoff — a failover on partition ``p3``
re-resolves ``p3``'s lease only; the other P-1 routing entries stay warm and
there is never a whole-map refresh storm.

Migration windows surface as
:class:`~metrics_tpu_torch.guard.errors.TenantQuarantined` from the *source*
partition (the migration guard holds the tenant there). The client treats
that as a routing-table staleness signal: reload the partition map once,
and if the tenant's partition moved, retry at the new home; if it did not
move, the quarantine is real (mid-migration or genuinely poisonous) and
propagates to the caller.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Hashable, Mapping, Optional

from metrics_tpu_torch.cluster.client import ClusterClient
from metrics_tpu_torch.cluster.store import CoordStore, Lease, Member
from metrics_tpu_torch.guard.errors import TenantQuarantined
from metrics_tpu_torch.part.pmap import PartitionMap

__all__ = ["PartitionedClient"]


class _LeaseView:
    """A :class:`CoordStore` facade scoped to ONE named lease.

    ``ClusterClient`` speaks the default-lease API (``read_lease()``); the
    partition plane keys P leases by name in one store. This adapter binds a
    partition name into every lease read so an unmodified ``ClusterClient``
    routes against exactly its partition's leadership.
    """

    def __init__(self, store: CoordStore, name: str) -> None:
        self._store = store
        self._name = name

    def now(self) -> float:
        return self._store.now()

    def read_lease(self, name: str = "") -> Optional[Lease]:
        return self._store.read_lease(self._name)

    def members(self) -> Dict[str, Member]:
        return self._store.members()


class PartitionedClient:
    """Route tenant traffic across a partitioned cluster.

    ``engines`` maps node id → (partition id → engine handle): every node runs
    one engine per partition, and the per-partition router sees only the
    column of engines serving its partition. All ``ClusterClient`` knobs pass
    through; each partition's router gets a distinct derived ``rng_seed`` so
    replica picks and backoff jitter decorrelate across partitions.
    """

    def __init__(
        self,
        store: CoordStore,
        engines: Mapping[str, Mapping[int, Any]],
        *,
        pmap: Optional[PartitionMap] = None,
        partitions: Optional[int] = None,
        retries: int = 8,
        backoff_s: float = 0.02,
        backoff_cap_s: float = 0.5,
        sleep: Callable[[float], None] = time.sleep,
        rng_seed: Optional[int] = None,
        lease_reread_s: float = 0.25,
    ) -> None:
        if pmap is None:
            if partitions is None:
                raise ValueError("PartitionedClient needs pmap or partitions")
            pmap = PartitionMap(partitions)
        self.pmap = pmap
        self._store = store
        self._routers: Dict[int, ClusterClient] = {}
        for pid in range(pmap.partitions):
            name = pmap.name_of(pid)
            column = {
                node: node_engines[pid]
                for node, node_engines in engines.items()
                if pid in node_engines
            }
            self._routers[pid] = ClusterClient(
                _LeaseView(store, name),
                column,
                retries=retries,
                backoff_s=backoff_s,
                backoff_cap_s=backoff_cap_s,
                sleep=sleep,
                rng_seed=(rng_seed + pid) if rng_seed is not None else None,
                lease_reread_s=lease_reread_s,
            )

    # ------------------------------------------------------------------ resolve

    def router(self, pid: int) -> ClusterClient:
        return self._routers[pid]

    def partition_of(self, key: Hashable) -> int:
        return self.pmap.partition_of(key)

    def leader_of(self, pid: int, *, refresh: bool = False) -> Optional[str]:
        """The node currently leading partition ``pid`` (None mid-election)."""
        return self._routers[pid].leader_id(refresh=refresh)

    def routing_table(self) -> Dict[str, Optional[str]]:
        """Partition name → currently-resolved leader (cache state, not a
        fresh store sweep — exactly what the next request would use)."""
        return {
            self.pmap.name_of(pid): router.leader_id(refresh=False)
            for pid, router in self._routers.items()
        }

    @property
    def redirects(self) -> int:
        """Redirect bounces absorbed across ALL partitions' routers."""
        return sum(router.redirects for router in self._routers.values())

    # ------------------------------------------------------------------ routing

    def submit(self, key: Hashable, *args: Any, **kwargs: Any) -> Any:
        """Route one write to its tenant's partition leader."""
        pid = self.pmap.partition_of(key)
        try:
            return self._routers[pid].submit(key, *args, **kwargs)
        except TenantQuarantined:
            # possibly a migration hold at a stale routing entry: the tenant
            # may have moved partitions since our map snapshot. Reload once;
            # only a genuinely moved tenant earns a retry.
            self.pmap.reload()
            new_pid = self.pmap.partition_of(key)
            if new_pid == pid:
                raise
            return self._routers[new_pid].submit(key, *args, **kwargs)

    def compute(self, key: Hashable, *, prefer: str = "leader", **kwargs: Any) -> Any:
        """Route one read within the tenant's partition (leader truth or
        staleness-bounded replica, per ``prefer``)."""
        pid = self.pmap.partition_of(key)
        try:
            return self._routers[pid].compute(key, prefer=prefer, **kwargs)
        except TenantQuarantined:
            self.pmap.reload()
            new_pid = self.pmap.partition_of(key)
            if new_pid == pid:
                raise
            return self._routers[new_pid].compute(key, prefer=prefer, **kwargs)

    # ------------------------------------------------------------------ query plane

    def rollup(
        self, pid: int, *, prefer: str = "replica", window: bool = False
    ) -> "tuple[Any, str, bool]":
        """One partition's every-tenant fold (the global query's per-partition
        read), via the partition's redirect ladder. Returns the stamped
        :class:`~metrics_tpu_torch.query.rollup.PartitionRollup` with its partition
        name and serving node filled in, plus ``(node, served_by_leader)``
        provenance."""
        from dataclasses import replace as _dc_replace

        ru, node, is_leader = self._routers[pid].call("rollup", prefer=prefer, window=window)
        # the engine stamps what it knows locally; the router knows the
        # cluster-level identity this rollup must be reported under
        ru = _dc_replace(ru, partition=self.pmap.name_of(pid), node=node)
        return ru, node, is_leader

    def wal_watermark(
        self, pid: int, *, prefer: str = "replica", retries: Optional[int] = None
    ) -> "tuple[tuple[int, int], str, bool]":
        """One partition's ``(epoch, seq)`` WAL watermark — the cache
        revalidation probe. Two ints over the read path, follower-servable,
        behind the same staleness gate as the rollup it vouches for."""
        return self._routers[pid].call("wal_watermark", prefer=prefer, retries=retries)
