"""metrics_tpu_torch.ckpt — durable state plane: crash-safe checkpoint, recovery,
replay (port of ``metrics_tpu/ckpt``).

The persistence story for everything stateful in the library::

    from metrics_tpu_torch import ckpt

    metric.save("acc.ckpt")          # atomic, checksummed, lossless by default
    fresh = BinaryAccuracy()
    fresh.restore("acc.ckpt")        # strict schema validation; bit-identical compute()

    store = ckpt.SnapshotStore("/var/ckpt", retain=3)        # generational + GC
    writer = ckpt.AsyncCheckpointer(store, interval_s=30.0)  # background, bounded staleness
    writer.maybe_checkpoint(lambda: (state_tree, {"step": 7}))
    gen, snap = store.latest_valid()                         # skips corrupt generations

Layout: :mod:`~metrics_tpu_torch.ckpt.format` (MTCKPT1: versioned manifest +
per-leaf CRC32 + codec compression), :mod:`~metrics_tpu_torch.ckpt.store`
(atomic tmp+fsync+rename commits, retention, per-rank layout, WAL request
journal), :mod:`~metrics_tpu_torch.ckpt.writer` (async background
checkpointer), :mod:`~metrics_tpu_torch.ckpt.restore` (strict validation +
migration hooks + ``save``/``restore``), :mod:`~metrics_tpu_torch.ckpt.faults`
(torn-write/bit-flip/partial-manifest/disk-full injection for durability
tests).

The format, the file names and the directory layout are the JAX package's: a
snapshot or a WAL directory written by either package is read by the other.
Snapshots hold numpy leaves, never tensors. The engine integration (periodic
snapshots, WAL replay, restart recovery) lives in
:mod:`metrics_tpu_torch.engine.runtime` behind
``StreamingEngine(checkpoint=CheckpointConfig(...))``.
"""

from __future__ import annotations

from metrics_tpu_torch.ckpt.format import (
    FORMAT_VERSION,
    CorruptSnapshotError,
    Snapshot,
    dumps,
    loads,
    read_manifest,
)
from metrics_tpu_torch.ckpt.restore import (
    CKPT_SCHEMA_VERSION,
    CkptSchemaError,
    clear_migrations,
    migrate,
    register_migration,
    restore,
    save,
)
from metrics_tpu_torch.ckpt.store import RequestJournal, SnapshotStore, atomic_write
from metrics_tpu_torch.ckpt.writer import AsyncCheckpointer

__all__ = [
    "CKPT_SCHEMA_VERSION",
    "FORMAT_VERSION",
    "AsyncCheckpointer",
    "CkptSchemaError",
    "CorruptSnapshotError",
    "RequestJournal",
    "Snapshot",
    "SnapshotStore",
    "atomic_write",
    "clear_migrations",
    "dumps",
    "loads",
    "migrate",
    "read_manifest",
    "register_migration",
    "restore",
    "save",
]
