"""Shard plane: tenant-sharded serving over the device mesh (port of
``metrics_tpu/shard``).

One :class:`~metrics_tpu_torch.engine.StreamingEngine` caps the system at one
card's memory and one dispatcher thread. This plane consistent-hashes tenants onto N
shards — each a full engine with its own stacked slab, graph cache,
dispatcher, and guard plane — behind one router, with monotone rebalancing on
capacity growth.

    from metrics_tpu_torch.shard import ShardConfig, ShardedEngine

    engine = ShardedEngine(BinaryAccuracy(), config=ShardConfig(shards=8))
    engine.submit("tenant-a", preds, target)
    engine.compute("tenant-a")
"""

from metrics_tpu_torch.shard.engine import ShardConfig, ShardedEngine
from metrics_tpu_torch.shard.ring import DEFAULT_VNODES, HashRing, hash_bytes, stable_key_bytes

__all__ = [
    "DEFAULT_VNODES",
    "HashRing",
    "ShardConfig",
    "ShardedEngine",
    "hash_bytes",
    "stable_key_bytes",
]
