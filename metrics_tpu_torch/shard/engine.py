"""Tenant-sharded serving: N StreamingEngines behind one consistent-hash router
(port of ``metrics_tpu/shard/engine.py``).

One :class:`~metrics_tpu_torch.engine.StreamingEngine` owns ALL tenant state — one
card's memory and one dispatcher thread cap the whole system. :class:`ShardedEngine`
breaks that ceiling the way "Automatic Cross-Replica Sharding of Weight Update"
(PAPERS.md) partitions optimizer work: the *accumulation* state itself is
partitioned. Tenants are consistent-hashed (:mod:`metrics_tpu_torch.shard.ring`) onto
N shards; each shard is a full StreamingEngine with its own stacked
``KeyedState`` slab, CUDA stream and graph cache, dispatcher thread, and guard
plane — so N backlogs drain in parallel and guard policy (token buckets,
quarantine, backpressure) follows the tenant to its shard.

Concurrency contract:

- ``submit`` takes NO global lock. The ring lookup is pure math; the only lock
  on the path is one of ``_STRIPES`` striped locks (chosen by submitter thread
  id — disjoint submitter threads use disjoint locks) plus the target engine's
  own queue lock. A ``resize`` acquires ALL stripes, which is what quiesces
  submits during migration without making them pay for each other in steady
  state.
- Admin operations (``compute`` / ``compute_all`` / ``rotate_window`` /
  ``reset`` / ``resize`` / ``checkpoint_now`` / ``close``) serialize on one
  re-entrant ``_admin_lock``; none of them sits on the submit path.

Device placement: when ``place_on_mesh`` is on and the process sees more
than one GPU, shard *i* serves on ``cuda:{i % torch.cuda.device_count()}``
(``StreamingEngine(device=...)`` moves its clone of the metric there, and its
slab, stream and graphs follow), so shards update on distinct cards in
parallel. The JAX package exposes a ``Mesh`` and a ``NamedSharding`` for
introspection; here ``mesh`` is the tuple of cards the shards are dealt onto
and ``sharding`` the device of each shard in index order, and both are
``None`` when placement is off or one card (or none) is visible: then every
shard serves on the engine's default device (the ``device=`` given, else the
metric's), each with its own dispatcher thread and stream on that device.

Rebalancing: ``resize(new_shards)`` grows the hash ring monotonically (old
shards never trade tenants — only new shards steal ~K/M each), migrates exactly
the stolen tenants through the MTCKPT1 snapshot container (bit-identical
round trip, window ring segments included), and evicts them from their old
shard. With checkpointing configured, the migration commits in write-ahead
order: destination shards snapshot their installed copies, THEN the new-count
ring manifest is written, and only then are the source copies evicted (in
memory and via the sources' post-evict snapshots). A crash before the manifest
commit restarts under the old ring with every source copy intact; a crash
after it restarts under the new ring, where the recovery sweep evicts any
tenant found on a shard the ring no longer routes it to (the double copy the
remaining window leaves behind). No ordering leaves a tenant's only copy on a
shard the manifest does not construct.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from metrics_tpu_torch.ckpt import format as ckpt_format
from metrics_tpu_torch.ckpt.restore import host_tree
from metrics_tpu_torch.engine.runtime import CheckpointConfig, StreamingEngine
from metrics_tpu_torch.engine.stream import KeyedState
from metrics_tpu_torch.kernels.engine_scan import leaves_like
from metrics_tpu_torch.obs import context as _obs_ctx
from metrics_tpu_torch.obs import instrument as _obs
from metrics_tpu_torch.obs.registry import OBS as _OBS
from metrics_tpu_torch.shard.ring import DEFAULT_VNODES, HashRing
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

_N_STRIPES = 16
_MANIFEST = "shard_manifest.json"

# distinguishes sharded engines within one process for the obs shard series
_SHARDED_IDS = itertools.count()


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """Shard-plane wiring for one :class:`ShardedEngine`.

    ``shards`` is the initial shard count; ``vnodes``/``seed`` parameterize the
    consistent-hash ring and MUST be stable across restarts of the same
    deployment (the checkpoint manifest enforces this — a changed ring would
    route tenants away from the shard whose WAL holds them). ``place_on_mesh``
    serves shard *i* on ``cuda:{i % ndevices}`` when more than one GPU is
    visible; off, every shard shares the default device (still N dispatcher
    threads and N streams, one device).
    """

    shards: int = 2
    vnodes: int = DEFAULT_VNODES
    seed: int = 0
    place_on_mesh: bool = True


class ShardedEngine:
    """Consistent-hash tenant sharding over N parallel :class:`StreamingEngine` shards.

    Same per-tenant semantics as one StreamingEngine — per-tenant results are
    bit-identical to a single-engine oracle for commutative (integer-state)
    metrics under any submit interleaving, and for all metrics when each
    tenant's updates are submitted from one thread (the same sequential-
    semantics contract the unsharded engine documents).

    Example::

        engine = ShardedEngine(BinaryAccuracy(), config=ShardConfig(shards=8))
        engine.submit("tenant-a", preds, target)
        engine.compute("tenant-a")
        engine.resize(16)          # doubling: only new shards steal tenants
        engine.close()
    """

    def __init__(
        self,
        metric_or_collection: Any,
        *,
        config: Optional[ShardConfig] = None,
        checkpoint: Optional[CheckpointConfig] = None,
        start: bool = True,
        **engine_kwargs: Any,
    ) -> None:
        self._config = config or ShardConfig()
        if self._config.shards < 1:
            raise MetricsTPUUserError(
                f"ShardedEngine needs >= 1 shard, got {self._config.shards}"
            )
        self._metric_template = metric_or_collection
        self._engine_kwargs = dict(engine_kwargs)
        self._ckpt_cfg = checkpoint
        self._start = start
        self.engine_id = str(next(_SHARDED_IDS))

        self._ring = HashRing(
            self._config.shards, vnodes=self._config.vnodes, seed=self._config.seed
        )
        # striped submit locks: submit holds ITS thread's stripe; resize holds
        # ALL of them. Stripes are dealt round-robin per submitter thread (raw
        # thread ids are pointer-aligned and would pile onto one stripe), so
        # disjoint submitter threads get disjoint locks and the steady-state
        # cost is one uncontended acquire.
        self._stripes = [threading.Lock() for _ in range(_N_STRIPES)]
        self._stripe_local = threading.local()
        self._stripe_counter = itertools.count()
        # submit-path route memo: ring hashing (stable key encoding + the
        # murmur fold) is pure Python and would dominate a batch-1 submit.
        # One entry per live tenant; cleared under ALL stripes when resize
        # swaps the ring. CPython dict get/set are atomic, so concurrent
        # stripes may share it without their own lock.
        self._route_cache: Dict[Hashable, int] = {}
        self._admin_lock = threading.RLock()
        self._closed = False

        self._devices: List[torch.device] = []
        self.mesh: Optional[Tuple[torch.device, ...]] = None
        if self._config.place_on_mesh and torch.cuda.is_available() and torch.cuda.device_count() > 1:
            self._devices = [torch.device(f"cuda:{j}") for j in range(torch.cuda.device_count())]
            self.mesh = tuple(self._devices)

        if checkpoint is not None:
            self._check_or_write_manifest(checkpoint.directory)

        self._engines: List[StreamingEngine] = [
            self._build_shard(i, start=start) for i in range(self._config.shards)
        ]
        if checkpoint is not None:
            self._recovery_sweep()
        self._publish_tenant_gauges()

    # ------------------------------------------------------------- construction

    def _build_shard(self, index: int, *, start: bool = True) -> StreamingEngine:
        kwargs = dict(self._engine_kwargs)
        if self._devices:
            kwargs["device"] = self._devices[index % len(self._devices)]
        kwargs["telemetry_labels"] = {"shard": str(index)}
        # tiered shards spill to per-shard subdirectories: shard indexes are
        # stable across restarts (the manifest pins the ring), so a recovered
        # shard finds exactly its own cold files
        tier_cfg = kwargs.get("tier")
        if tier_cfg is not None and tier_cfg.spill_directory:
            kwargs["tier"] = dataclasses.replace(
                tier_cfg,
                spill_directory=os.path.join(
                    tier_cfg.spill_directory, f"shard-{index:03d}"
                ),
            )
        if self._ckpt_cfg is not None:
            kwargs["checkpoint"] = dataclasses.replace(
                self._ckpt_cfg,
                directory=os.path.join(self._ckpt_cfg.directory, f"shard-{index:03d}"),
            )
        return StreamingEngine(self._metric_template, start=start, **kwargs)

    def _check_or_write_manifest(self, directory: str) -> None:
        """Ring parameters ride in the checkpoint directory: a restart with a
        different ring would route tenants away from the shard whose snapshot/WAL
        holds them, which must be a crash at construction, not silent data loss."""
        path = os.path.join(directory, _MANIFEST)
        want = {
            "shards": self._config.shards,
            "vnodes": self._config.vnodes,
            "seed": self._config.seed,
        }
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as fh:
                have = json.load(fh)
            if (have.get("vnodes"), have.get("seed")) != (want["vnodes"], want["seed"]):
                raise MetricsTPUUserError(
                    f"shard manifest at {path} was written with ring parameters "
                    f"vnodes={have.get('vnodes')}, seed={have.get('seed')} but this "
                    f"engine was configured with vnodes={want['vnodes']}, "
                    f"seed={want['seed']} — a changed ring strands tenants on "
                    "shards the router no longer reaches"
                )
            if int(have.get("shards", 0)) != want["shards"]:
                raise MetricsTPUUserError(
                    f"shard manifest at {path} records {have.get('shards')} shards "
                    f"but this engine was configured with {want['shards']}; resume "
                    "with the recorded count, then resize()"
                )
            return
        self._write_manifest(directory, want)

    @staticmethod
    def _write_manifest(directory: str, manifest: Dict[str, Any]) -> None:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, _MANIFEST)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(manifest, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)

    def _recovery_sweep(self) -> None:
        """Evict recovered tenants from shards the ring does not route them to.

        Two sources: a crash mid-``resize`` after the new-count manifest
        committed but before the sources' post-evict checkpoints did (tenant
        present on BOTH shards — the ring says the destination owns it, so the
        stale source copy must go), and operator error re-homing a checkpoint
        tree. The ring's copy is authoritative; the stale copy is dropped, not
        merged (migration copied the full state, so merging would double-count).
        """
        for index, engine in enumerate(self._engines):
            stale = [
                key
                for key in self._shard_keys(engine)
                if self._ring.shard_for(key) != index
            ]
            for key in stale:
                # journaled retire: releases the slot to the free-list (or drops
                # the tier entry + spill file) and makes the NEXT recovery agree
                engine.evict_tenant(key)

    @staticmethod
    def _shard_keys(engine: StreamingEngine) -> List[Hashable]:
        """Every tenant one shard knows: slab-resident plus warm/cold tiered."""
        keys = list(engine._keyed.keys)
        if engine._tier is not None:
            keys.extend(engine._tier.keys())
        return keys

    # ------------------------------------------------------------------ routing

    @property
    def shards(self) -> int:
        return len(self._engines)

    @property
    def engines(self) -> Tuple[StreamingEngine, ...]:
        """The per-shard engines, in shard-index order (tests/ops introspection)."""
        return tuple(self._engines)

    @property
    def ring(self) -> HashRing:
        return self._ring

    @property
    def sharding(self) -> Optional[Tuple[torch.device, ...]]:
        """Each shard's device in index order, or ``None`` without placement."""
        if self.mesh is None:
            return None
        return tuple(engine.device for engine in self._engines)

    def shard_of(self, key: Hashable) -> int:
        """The shard index the ring currently routes ``key`` to."""
        with self._admin_lock:
            return self._ring.shard_for(key)

    @property
    def keys(self) -> Tuple[Hashable, ...]:
        """Every registered tenant, shard-index order then per-shard insertion order."""
        with self._admin_lock:
            out: List[Hashable] = []
            for engine in self._engines:
                out.extend(self._shard_keys(engine))
            return tuple(out)

    # ------------------------------------------------------------------- writes

    def submit(
        self,
        key: Hashable,
        *args: Any,
        deadline: Optional[float] = None,
        priority: int = 0,
    ) -> Any:
        """Route one update to its tenant's shard; returns that shard's Future.

        The stripe lock pins the ring↔engine pairing against a concurrent
        ``resize`` (which holds every stripe while it migrates); it is NOT a
        global submit lock — submitter threads on different stripes proceed
        concurrently, and the per-shard queues/backpressure they land in are
        independent.
        """
        # mint (or adopt) the trace context HERE so the traced request id is
        # the one the caller saw at the sharded front door, then activate it
        # around the delegated submit: the shard's inner engine adopts the
        # ambient context instead of minting a second, unlinked trace
        ctx = _obs_ctx.mint_or_current() if _OBS.enabled else None
        stripe = getattr(self._stripe_local, "lock", None)
        if stripe is None:
            stripe = self._stripes[next(self._stripe_counter) % _N_STRIPES]
            self._stripe_local.lock = stripe
        with stripe:
            index = self._route_cache.get(key)
            if index is None:
                index = self._ring.shard_for(key)
                self._route_cache[key] = index
            with _obs_ctx.activate(ctx):
                return self._engines[index].submit(
                    key, *args, deadline=deadline, priority=priority
                )

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until every accepted request on every shard has committed.

        Serializes with ``resize`` on the admin lock: a flush that overlapped a
        rebalance could otherwise return while newly born shards still held
        unflushed migrated work.
        """
        with self._admin_lock:
            for engine in self._engines:
                engine.flush(timeout=timeout)

    # -------------------------------------------------------------------- reads

    def compute(self, key: Hashable, *, window: bool = False, sync: bool = False) -> Any:
        """Final metric value for tenant ``key`` (flushes its shard first).

        Held under the admin lock end-to-end: a concurrent ``resize`` may move
        the tenant between the ring lookup and the shard read, and computing on
        a shard that just evicted the key would KeyError.
        """
        with self._admin_lock:
            engine = self._engines[self._ring.shard_for(key)]
            return engine.compute(key, window=window, sync=sync)

    def compute_all(self, *, window: bool = False, sync: bool = False) -> Dict[Hashable, Any]:
        """``compute`` for every tenant on every shard.

        Shards are visited in index order — the ring is deterministic across
        processes, so every rank of a multi-host job issues ``sync=True``
        collectives in the same shard order (per-shard tenant order carries the
        same single-writer caveat as the unsharded engine's ``compute_all``).
        Each shard's slice is point-in-time consistent; the union is as
        consistent as N sequential per-shard snapshots can be.
        """
        with self._admin_lock:
            out: Dict[Hashable, Any] = {}
            for engine in self._engines:
                out.update(engine.compute_all(window=window, sync=sync))
            return out

    def register_tenants(self, keys: Sequence[Hashable]) -> int:
        """Register tenants as cold residents on their ring-routed shards.

        Requires the shards to be built with ``tier=TierConfig(...)``. Routes
        each key once and batches per shard; returns how many were new."""
        with self._admin_lock:
            buckets: Dict[int, List[Hashable]] = {}
            for key in keys:
                buckets.setdefault(self._ring.shard_for(key), []).append(key)
            added = 0
            for index, batch in buckets.items():
                added += self._engines[index].register_tenants(batch)
        self._publish_tenant_gauges()
        return added

    def tenant_tier(self, key: Hashable) -> Optional[str]:
        """Which tier ``key`` occupies on its shard (None = unknown tenant)."""
        with self._admin_lock:
            return self._engines[self._ring.shard_for(key)].tenant_tier(key)

    def tier_stats(self) -> Dict[str, Any]:
        """Summed residency counts + slab bytes, with the per-shard stats under
        ``"shards"`` (index order)."""
        with self._admin_lock:
            per_shard = [engine.tier_stats() for engine in self._engines]
        out: Dict[str, Any] = {
            field: sum(stats[field] for stats in per_shard)
            for field in ("hot", "warm", "cold", "pinned", "slab_bytes")
        }
        out["shards"] = per_shard
        return out

    def health(self) -> Dict[str, Any]:
        """Aggregate state (worst shard wins) + the per-shard health dicts."""
        with self._admin_lock:
            per_shard = [engine.health() for engine in self._engines]
            ring_repr = repr(self._ring)
        order = {"SERVING": 0, "DEGRADED": 1, "QUARANTINED": 2}
        worst = max((h["state"] for h in per_shard), key=lambda s: order.get(s, 2))
        return {"state": worst, "shards": per_shard, "ring": ring_repr}

    def telemetry_snapshot(self) -> Dict[str, Any]:
        """Additive sums across shards + the per-shard snapshots (keyed by index).

        Only additive series are summed into the top level: the integer event
        counters and gauges (``processed``, ``queue_depth``, ...) plus the
        ``resize_seconds`` wall-time counter. Non-additive series — latency
        quantiles, occupancy histograms, mean ratios — appear only under the
        per-shard sub-dicts (the sum of eight per-shard p50s is not a p50).
        """
        with self._admin_lock:
            shards = {str(i): e.telemetry.snapshot() for i, e in enumerate(self._engines)}
        totals: Dict[str, Any] = {}
        for snap in shards.values():
            for name, val in snap.items():
                if isinstance(val, bool) or not isinstance(val, (int, float)):
                    continue
                if isinstance(val, int) or name == "resize_seconds":
                    totals[name] = totals.get(name, 0) + val
        totals["shards"] = shards
        return totals

    # ----------------------------------------------------------- admin lifecycle

    def rotate_window(self) -> None:
        """Close the sliding-window segment on EVERY shard.

        One call rotates all shards under the admin lock, so ring segment
        counts stay index-aligned across shards — rebalance migration copies a
        tenant's window contributions segment-by-segment on that alignment.
        """
        with self._admin_lock:
            for engine in self._engines:
                engine.rotate_window()

    def reset(self) -> None:
        with self._admin_lock:
            for engine in self._engines:
                engine.reset()

    def checkpoint_now(self) -> List[Optional[int]]:
        """Synchronous snapshot per shard; the committed generations, index order."""
        with self._admin_lock:
            return [engine.checkpoint_now() for engine in self._engines]

    def close(self, flush: bool = True, checkpoint: bool = True) -> None:
        with self._admin_lock:
            if self._closed:
                return
            self._closed = True
            for engine in self._engines:
                engine.close(flush=flush, checkpoint=checkpoint)

    # -------------------------------------------------------------- rebalancing

    def resize(self, new_shards: int) -> Dict[Hashable, Tuple[int, int]]:
        """Grow to ``new_shards`` shards, migrating only the tenants the ring moves.

        Monotone ring growth means every move goes old-shard → NEW-shard
        (≈K/new_shards stolen per new shard); each moved tenant's state — live
        segment AND window ring rows — round-trips through the MTCKPT1
        snapshot container, bit-identically. Submits are quiesced for the
        duration (all stripes held); in-flight work is flushed first so the
        copied state is complete. Returns ``{key: (from_shard, to_shard)}``.

        Crash safety (checkpointing on) is write-ahead ordering: copies are
        installed on the destinations WITHOUT evicting the sources, the
        destination (born) shards checkpoint, the new-count ring manifest
        commits, and only then are the source copies evicted and the sources'
        post-evict checkpoints taken. A crash before the manifest commit
        restarts under the old ring with every source copy intact (the born
        directories hold only stale bytes, dropped by the next resize); a
        crash after it restarts under the new ring, whose recovery sweep
        resolves the double copies in the destination's favor. At no point is
        a tenant's only durable copy on a shard the manifest does not
        construct.
        """
        with self._admin_lock:
            if self._closed:
                raise MetricsTPUUserError("resize() on a closed ShardedEngine")
            if new_shards <= len(self._engines):
                raise MetricsTPUUserError(
                    f"resize() only grows: {new_shards} <= current {len(self._engines)}"
                )
            new_ring = self._ring.grown(new_shards)
            # build the new shards before quiescing submits — the stripe hold
            # should cover migration only, not engine construction. They run
            # (or not) under the same lifecycle flag as the original shards.
            born = [
                self._build_shard(i, start=self._start)
                for i in range(len(self._engines), new_shards)
            ]
            # A born shard may reuse a shard-NNN directory left by a resize
            # that crashed before its manifest committed, and resume=True will
            # have recovered that leftover state. It is stale by construction:
            # the old-count manifest means the original shards recovered every
            # authoritative copy (sources are never durably evicted ahead of
            # the manifest). Drop it all before migration installs fresh
            # copies, or resurrected tenants would duplicate live ones.
            for engine in born:
                for key in self._shard_keys(engine):
                    engine.evict_tenant(key)
            for stripe in self._stripes:
                stripe.acquire()
            try:
                engines = self._engines + born
                # flush under the stripes: after this no shard has queued or
                # in-flight work, so dispatch-lock state reads are complete
                for engine in self._engines:
                    engine.flush()
                moved: Dict[Hashable, Tuple[int, int]] = {}
                for src_idx, src in enumerate(self._engines):
                    # every tenant the shard knows migrates, whatever tier it
                    # occupies: hot rows copy from the slab, warm/cold entries
                    # copy without readmission (no slab churn during a resize)
                    for key in self._shard_keys(src):
                        dst_idx = new_ring.shard_for(key)
                        if dst_idx == src_idx:
                            continue
                        self._copy_tenant(src, engines[dst_idx], key)
                        moved[key] = (src_idx, dst_idx)
                if self._ckpt_cfg is not None:
                    # destination durability, then the ring that routes to it,
                    # then source eviction — see the docstring's crash argument
                    if any(engine.checkpoint_now() is None for engine in born):
                        for engine in born:
                            engine.close(flush=False, checkpoint=False)
                        raise RuntimeError(
                            "resize() aborted: a destination shard failed to "
                            "checkpoint its migrated tenants; the old ring and "
                            "every source copy are intact"
                        )
                    try:
                        self._write_manifest(
                            self._ckpt_cfg.directory,
                            {
                                "shards": new_shards,
                                "vnodes": self._config.vnodes,
                                "seed": self._config.seed,
                            },
                        )
                    except BaseException:
                        # abort pre-commit: the old ring and every source copy
                        # are untouched; only the born engines need unwinding
                        for engine in born:
                            engine.close(flush=False, checkpoint=False)
                        raise
                for key, (src_idx, _) in moved.items():
                    self._engines[src_idx].evict_tenant(key)
                if self._ckpt_cfg is not None:
                    for engine in self._engines:
                        engine.checkpoint_now()
                self._engines = engines
                self._ring = new_ring
                self._route_cache.clear()
                self._config = dataclasses.replace(self._config, shards=new_shards)
            finally:
                for stripe in self._stripes:
                    stripe.release()
        _obs.record_shard_rebalance(self.engine_id)
        self._publish_tenant_gauges()
        return moved

    def _copy_tenant(self, src: StreamingEngine, dst: StreamingEngine, key: Hashable) -> None:
        """Copy one tenant src → dst, bit-identically, through the ckpt container.

        The source copy is left in place (``retire=False``): ``resize`` evicts
        it only once the destination copy and the ring routing to it are both
        durable. The engine-level export/import pair handles every tier — a
        warm or cold tenant migrates without ever touching either slab, and a
        registered-but-silent one moves as a cold registration.
        """
        entry = src.export_tenant(key, retire=False)
        blob = ckpt_format.dumps(entry)
        dst.import_tenant(key, ckpt_format.loads(blob).tree)

    @staticmethod
    def _export_tenant(keyed: Any, key: Hashable) -> Dict[str, Any]:
        """One tenant's full state as a host tree: live segment + window ring rows
        (``None`` where the tenant had no contribution in a segment). The caller
        holds the shard's dispatch lock and has flushed it."""
        state = host_tree(keyed.state_of(key))
        ring_rows: List[Any] = []
        if isinstance(keyed, KeyedState):
            slot = keyed._slots[key]
            if keyed._ring is not None:
                for cap, snap in keyed._ring:
                    if slot >= cap:
                        ring_rows.append(None)
                    else:
                        ring_rows.append(host_tree(tree_map(lambda x: x[slot], snap)))
        else:
            if keyed._ring is not None:
                for seg in keyed._ring:
                    row = seg.get(key)
                    ring_rows.append(None if row is None else host_tree(row))
        return {"state": state, "ring": ring_rows}

    @staticmethod
    def _install_tenant(keyed: Any, key: Hashable, tree: Dict[str, Any]) -> None:
        """Install an :meth:`_export_tenant` tree (the caller holds the shard's
        dispatch lock). The live row is written in place; window ring segments
        are snapshots no graph reads, so a segment that predates the slot grows
        by a new tensor."""
        keyed.slot_for(key)
        keyed.ensure_capacity()
        keyed.set_state(key, tree["state"])
        rows = tree.get("ring") or []
        if not rows:
            return
        if isinstance(keyed, KeyedState):
            slot = keyed._slots[key]
            ring = keyed._ring
            if ring is None:
                return
            # segments align by index across shards: every rotation goes
            # through ShardedEngine.rotate_window, which rotates all shards —
            # except a shard born mid-life, whose ring starts empty and is
            # padded with init segments here so the alignment holds
            while len(ring) < len(rows):
                ring.append((keyed.capacity, tree_unflatten(keyed._tiled(keyed.capacity), keyed._treedef)))
            for j, row in enumerate(rows):
                if row is None or j >= len(ring):
                    continue
                cap, snap = ring[j]
                leaves = tree_flatten(snap)[0]
                if slot >= cap:
                    # the destination snapshot predates this slot: grow it so
                    # the migrated contribution has a row to land in
                    leaves = [
                        torch.cat([leaf, init.expand((keyed.capacity - cap,) + init.shape)], dim=0)
                        for leaf, init in zip(leaves, keyed._init_leaves)
                    ]
                    cap = keyed.capacity
                for leaf, new in zip(leaves, leaves_like(row, keyed._treedef)):
                    leaf[slot].copy_(torch.as_tensor(new))
                ring[j] = (cap, tree_unflatten(leaves, keyed._treedef))
        else:
            ring = keyed._ring
            if ring is None:
                return
            while len(ring) < len(rows):
                ring.append({})
            for j, row in enumerate(rows):
                if row is None or j >= len(ring):
                    continue
                ring[j][key] = row

    # ---------------------------------------------------------------------- obs

    def _publish_tenant_gauges(self) -> None:
        for index, engine in enumerate(self._engines):
            _obs.set_shard_tenants(
                self.engine_id, index, len(self._shard_keys(engine))
            )

    def publish_tenant_gauges(self) -> None:
        """Refresh ``metrics_tpu_torch_shard_tenants`` from the live slot maps (obs-gated)."""
        self._publish_tenant_gauges()
