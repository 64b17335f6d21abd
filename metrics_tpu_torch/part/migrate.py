"""Live tenant migration between partitions — destination-first, crash-safe
(port of ``metrics_tpu/part/migrate.py``).

Moving a tenant between partitions is the shard plane's ``resize()`` copy
discipline applied to ONE tenant while both partitions keep serving:

1. **Quarantine the source.** The migration guard *holds* the tenant on the
   source engine (:meth:`TenantQuarantine.hold`) so writes routed by a stale
   map refuse loudly (:class:`TenantQuarantined`) instead of mutating state
   that is about to move — the snapshot taken next is the final word.
2. **Snapshot through the checkpoint container.** ``export_tenant(retire=
   False)`` → ``ckpt_format.dumps`` → ``loads`` → ``import_tenant``: the
   same bytes a crash-recovery would restore, so the destination copy is
   bit-identical by construction — live segment AND window ring rows.
3. **Destination durability, then routing, then source eviction.** The
   destination checkpoints first; only then does the partition map commit
   the override (+ a bumped epoch floor for the destination partition) —
   THE commit point — and only after that does the source evict and
   checkpoint. A crash at any prefix leaves either (a) no routing change
   and an intact source (the hold is in-memory and dies with the process),
   or (b) committed routing and a possibly-surviving double copy, which
   :func:`sweep_partitions` resolves in the destination's favour on
   recovery — exactly the shard ``resize()`` argument.

The epoch-floor bump closes the fencing seam: the destination partition's
next election must land strictly above the epoch the handoff happened in, so
no pre-migration frame of the destination lineage can be confused with the
migrated tenant's post-migration writes.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, Mapping, Union

from metrics_tpu_torch.ckpt import format as ckpt_format
from metrics_tpu_torch.obs import instrument as _obs
from metrics_tpu_torch.part.pmap import PartitionMap
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

__all__ = ["migrate_tenant", "sweep_partitions"]


def _quarantine_of(engine: Any):
    guard = getattr(engine, "_guard", None)
    return getattr(guard, "quarantine", None) if guard is not None else None


def _checkpoint_engine(engine: Any):
    """Snapshot WITHOUT ``checkpoint_now()``'s whole-engine flush barrier.

    The migration's durable artifacts — the destination's ``b"P"`` import
    record and the source's ``b"T"`` retirement record — are WAL-journaled
    synchronously under the dispatch lock, so ``_checkpoint_view`` taken right
    after them is consistent and already reflects the move. A full flush here
    would wait for every NEIGHBOURING tenant's traffic to drain, which never
    happens on a partition under sustained load. Returns the generation, or
    ``None`` when checkpointing is off / quarantined / the write failed.

    The port's slab is written in place by every replay, so the view is copied
    to the host under the dispatch lock on the engine's stream (what
    ``_checkpoint_view`` does, as ``rollup`` folds): after every replay
    enqueued before it, before any enqueued after.
    """
    writer = getattr(engine, "_ckpt_writer", None)
    if writer is None or getattr(engine, "_quarantined", False):
        return None
    return writer.checkpoint_sync(engine._checkpoint_view)


def _engine_knows(engine: Any, key: Hashable) -> bool:
    """Whether ``key`` is resident on ``engine`` (slab or any tier) — the
    same membership test :func:`sweep_partitions` uses, no export needed."""
    if key in engine._keyed.keys:
        return True
    tier = getattr(engine, "_tier", None)
    return tier is not None and key in set(tier.keys())


def _plan_doc(
    key: Hashable,
    src_pid: int,
    dst_pid: int,
    *,
    pmap: PartitionMap,
    src_engine: Any,
    dst_engine: Any,
) -> Dict[str, Any]:
    """The validated migration plan, journal-shaped (what WOULD happen)."""
    return {
        "what": "migration_plan",
        "tenant": repr(key),
        "src_pid": src_pid,
        "dst_pid": dst_pid,
        "src_writable": not getattr(src_engine, "_repl_follower", False),
        "dst_writable": not getattr(dst_engine, "_repl_follower", False),
        "tenant_known_to_source": _engine_knows(src_engine, key),
        "quarantine_hold": _quarantine_of(src_engine) is not None,
        "dst_checkpointed_first": getattr(dst_engine, "_ckpt_writer", None) is not None,
        # the floor the commit would record: strictly above the epoch the
        # handoff would happen under, so no later dst election can promote
        # at-or-below it
        "epoch_floor": int(getattr(dst_engine, "_repl_epoch", 0)) + 1,
        "commit": "manifest" if pmap.directory is not None else "memory",
    }


def migrate_tenant(
    key: Hashable,
    dst_pid: int,
    *,
    pmap: PartitionMap,
    src_engine: Any,
    dst_engine: Any,
    node_id: str = "",
    dry_run: bool = False,
) -> Union[bool, Dict[str, Any]]:
    """Move tenant ``key`` to partition ``dst_pid``, live and bit-identically.

    ``src_engine`` / ``dst_engine`` are the writable *leaders* of the tenant's
    current and destination partitions (callers resolve leadership; this
    function enforces the copy/commit ordering). Returns False if the tenant
    already routes to ``dst_pid`` (no-op), True on a completed migration.
    Raises :class:`MetricsTPUUserError` if the source does not know the
    tenant. On failure before the map commit, the source hold is released and
    nothing has changed durably.

    ``dry_run=True`` validates the full plan — source/destination
    writability, tenant residency, quarantine hold availability, the epoch
    floor the commit would record, and where the routing would commit — and
    returns it as a dict WITHOUT executing anything (no hold is taken, no
    state moves). A ``plan["valid"]`` of True means the same call without
    ``dry_run`` would proceed past every precondition; the autopilot journals
    exactly this document before acting, and operators get a free "what would
    move" probe.
    """
    dst_pid = int(dst_pid)
    src_pid = pmap.partition_of(key)
    if src_pid == dst_pid:
        if dry_run:
            return {
                "what": "migration_plan", "tenant": repr(key),
                "src_pid": src_pid, "dst_pid": dst_pid,
                "noop": True, "valid": False,
                "why": "tenant already routes to the destination partition",
            }
        return False
    pmap.name_of(dst_pid)  # range check before any side effect

    if dry_run:
        plan = _plan_doc(key, src_pid, dst_pid, pmap=pmap,
                         src_engine=src_engine, dst_engine=dst_engine)
        plan["noop"] = False
        plan["valid"] = bool(
            plan["src_writable"] and plan["dst_writable"]
            and plan["tenant_known_to_source"]
        )
        if not plan["valid"]:
            plan["why"] = (
                "source is not writable" if not plan["src_writable"]
                else "destination is not writable" if not plan["dst_writable"]
                else "tenant is unknown to its partition leader"
            )
        return plan

    quarantine = _quarantine_of(src_engine)
    if quarantine is not None:
        quarantine.hold(key)
    try:
        # everything accepted so far FOR THIS TENANT lands in the exported
        # state. The hold above stops new rows for the key, so a per-tenant
        # drain suffices — a whole-engine flush() barrier never clears while
        # neighbouring tenants keep the source busy, and a live migration
        # must not require a quiet engine.
        src_engine.drain_tenant(key)
        entry = src_engine.export_tenant(key, retire=False)
        if entry is None:
            raise MetricsTPUUserError(
                f"tenant {key!r} is unknown to its partition p{src_pid} leader — "
                "nothing to migrate"
            )
        # bit-identical by construction: the exact bytes recovery would restore
        blob = ckpt_format.dumps(entry)
        dst_engine.import_tenant(key, ckpt_format.loads(blob).tree)
        if getattr(dst_engine, "_ckpt_writer", None) is not None:
            if _checkpoint_engine(dst_engine) is None:
                raise MetricsTPUUserError(
                    f"destination partition p{dst_pid} checkpoint failed — "
                    "migration aborted before the routing commit"
                )
        # fencing seam: the destination's next election must outrank the epoch
        # this handoff happened under
        floor = int(getattr(dst_engine, "_repl_epoch", 0)) + 1
        pmap.set_epoch_floor(dst_pid, floor)
        pmap.set_override(key, dst_pid)
        if pmap.directory is not None:
            pmap.commit()  # THE commit point: routing now names the destination
    except BaseException:
        # pre-commit failure: un-hold so the source keeps serving untouched
        if quarantine is not None:
            quarantine.release(key)
        raise
    # post-commit: the destination owns the tenant; retire the source copy.
    # A crash in here leaves a routed-away double copy for sweep_partitions.
    src_engine.evict_tenant(key)
    _checkpoint_engine(src_engine)
    # the hold STAYS on the source: a client still routing on a stale map
    # must refuse loudly (TenantQuarantined -> map reload) rather than
    # silently re-create the evicted tenant at init state. One held entry per
    # migrated-away tenant is the price of that refusal.
    shipper = getattr(dst_engine, "_shipper", None)
    if shipper is not None:
        # followers of the destination partition re-bootstrap so the imported
        # tenant reaches the replica set as a snapshot, not a mid-stream gap
        shipper._need_snapshot = True
    _obs.record_part_migration(node_id)
    return True


def sweep_partitions(pmap: PartitionMap, engines: Mapping[int, Any]) -> int:
    """Evict tenants that no longer route to the partition holding them.

    The recovery half of the migration crash argument: if the process died
    between the map commit and the source eviction, the source WAL still
    replays the migrated tenant. The committed map is the truth — any tenant
    whose :meth:`PartitionMap.partition_of` disagrees with its resident
    partition is a superseded double copy and is evicted (the destination's
    copy was durable before the commit, by ordering). Run over writable
    engines after recovery. Returns the number of evictions.
    """
    evicted = 0
    for pid, engine in engines.items():
        keys = list(engine._keyed.keys)
        tier = getattr(engine, "_tier", None)
        if tier is not None:
            keys.extend(tier.keys())
        for key in keys:
            if pmap.partition_of(key) != pid:
                engine.evict_tenant(key)
                evicted += 1
    return evicted
