"""Partition plane — multi-leader keyspace partitioning (port of
``metrics_tpu/part``).

The cluster plane scales *availability* (one writable leader survives any
single host); it cannot scale *writes* — one leader means one host's WAL
bandwidth no matter how many hosts join. This plane splits the tenant
keyspace into P partitions on a seeded consistent-hash ring and runs the
cluster plane's leadership machinery once per partition: every partition has
its own named CAS-with-TTL lease, its own monotone fencing epoch, its own
``StreamingEngine`` WAL/ckpt lineage, and its own follower set. N hosts lead
~P/N partitions each, so aggregate write throughput scales with hosts while
every per-partition guarantee (at-most-one-writer, exactly-once
order-preserving replication, fenced zombie leaders) holds unchanged::

    from metrics_tpu_torch.part import PartConfig, PartitionMap, PartitionedClient, PartitionedNode
    from metrics_tpu_torch.cluster import DirectoryCoordStore
    from metrics_tpu_torch.repl import DirectoryTransport

    store = DirectoryCoordStore("/shared/coord")
    link = lambda src, dst, part: DirectoryTransport(f"/shared/links/{src}-{dst}-{part}")
    node = PartitionedNode(engines_by_pid, PartConfig(
        node_id="a", peers=("b", "c"), store=store, partitions=8, link_factory=link))

    client = PartitionedClient(store, {"a": a_engines, "b": b_engines, "c": c_engines},
                               pmap=node.pmap)
    client.submit(key, preds, target)   # routed to key's partition's leader

Killing a host that leads k partitions triggers k *independent* failovers —
each a ranked election over that partition's bootstrapped followers — and the
blast radius of any one failover is one partition's tenants, not the fleet.
Tenants move between partitions live (:func:`migrate_tenant`): quarantined on
the source, shipped bit-identically through the checkpoint container, and
handed off destination-first so a crash at any point is recoverable. See the
JAX package's ``docs/source/partitions.md`` for the at-most-one-writer-per-
partition argument and the migration walkthrough. The partition manifest, the
coordination records, a migrated tenant's MTCKPT1 entry and its ``P``/``T``
WAL records are the JAX package's formats, read by either package.
"""

from metrics_tpu_torch.part.client import PartitionedClient
from metrics_tpu_torch.part.config import PartConfig
from metrics_tpu_torch.part.migrate import migrate_tenant, sweep_partitions
from metrics_tpu_torch.part.node import PartitionedNode
from metrics_tpu_torch.part.pmap import PartitionMap, partition_name

__all__ = [
    "PartConfig",
    "PartitionMap",
    "PartitionedClient",
    "PartitionedNode",
    "migrate_tenant",
    "partition_name",
    "sweep_partitions",
]
