"""Instrumentation hooks of the metric core, the kernel plane, the comm plane,
the engine and its durable, guard, tier and replication planes, the cluster,
partition, shard, query and pilot planes (port of the metric, kernel, sync,
comm, engine, ckpt, guard, tier, repl, cluster, partition, shard, query and
pilot sections of ``metrics_tpu/obs/instrument.py``).

Every hook returns at once, or hands back a shared no-op, while ``OBS.enabled``
is false. Unlike the JAX package, whose callers are jitted and so count
compiled lowerings, PyTorch runs eagerly: the kernel hooks count calls. The
spans land in the process tracer (:data:`~metrics_tpu_torch.obs.trace.TRACER`),
and the guard's quarantines, watchdog restarts, breaker openings, an
engine's quarantine, a lost election, a live set that shrank and a failed
pilot action dump flight-recorder bundles
(:data:`~metrics_tpu_torch.obs.flight.FLIGHT`), as in the JAX package.
"""

from __future__ import annotations

import itertools
import math
import time
from typing import Any, Optional

from metrics_tpu_torch.obs.flight import FLIGHT
from metrics_tpu_torch.obs.registry import OBS, REGISTRY
from metrics_tpu_torch.obs.trace import _NULL_SPAN, TRACER

OP_SECONDS = REGISTRY.histogram(
    "metrics_tpu_torch_op_seconds",
    "Wall time of metric operations (op=update|compute|sync), per metric class and instance.",
)

KERNEL_DISPATCHES = REGISTRY.counter(
    "metrics_tpu_torch_kernel_dispatch_total",
    "Kernel-plane registry dispatches per entry and impl (optimized|reference), one per call.",
)
KERNEL_LAUNCHES = REGISTRY.counter(
    "metrics_tpu_torch_kernel_launches_total",
    "CUDA kernel launches per kernel, counted by the wrapper where it launches.",
)

_BYTE_BUCKETS = (64.0, 1024.0, 16384.0, 262144.0, 4194304.0, 67108864.0)

SYNC_BYTES = REGISTRY.counter(
    "metrics_tpu_torch_sync_bytes_total",
    "Cumulative state-tree payload bytes moved through HOST-level distributed sync (counted per call).",
)
SYNC_TRACED_BYTES = REGISTRY.counter(
    "metrics_tpu_torch_sync_traced_bytes_total",
    "Payload accounting for in-trace collectives (reduce_in_trace): bytes each call of the "
    "collective moves per participant, counted per call — eager PyTorch has no compile to "
    "count once; a captured CUDA graph counts once, at capture.",
)
SYNC_PAYLOAD = REGISTRY.histogram(
    "metrics_tpu_torch_sync_payload_bytes",
    "State-tree byte size per host-level sync/all-gather.",
    buckets=_BYTE_BUCKETS,
)


# Bounded per-instance labelling: the registry never evicts, so the label is a
# monotone issue number stored on the object, and instances past the cap share
# one overflow label (per-class series stay exact).
_INSTANCE_CAP = 256
_INSTANCE_ATTR = "_obs_instance_label"
_instance_ids = itertools.count()


def instance_label(obj: Any) -> str:
    """Stable-for-the-lifetime-of-the-object instance id label (bounded set)."""
    label = getattr(obj, _INSTANCE_ATTR, None)
    if label is not None:
        return label
    n = next(_instance_ids)
    label = str(n) if n < _INSTANCE_CAP else "overflow"
    try:
        object.__setattr__(obj, _INSTANCE_ATTR, label)
    except (AttributeError, TypeError):  # slotted or immutable hosts: don't burn cap slots on them
        return "untracked"
    return label


class _OpTimer:
    """Span + wall-time histogram around one metric operation."""

    __slots__ = ("_op", "_metric", "_instance", "_span", "_t0")

    def __init__(self, op: str, metric: str, instance: str) -> None:
        self._op = op
        self._metric = metric
        self._instance = instance

    def __enter__(self) -> "_OpTimer":
        self._span = TRACER.span(f"metric.{self._op}", metric=self._metric)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        dur = time.perf_counter() - self._t0
        self._span.__exit__(exc_type, exc, tb)
        OP_SECONDS.observe(dur, op=self._op, metric=self._metric, instance=self._instance)
        return False

    def set_attr(self, **attrs: Any) -> None:
        self._span.set_attr(**attrs)


def metric_op(op: str, owner: Any) -> Any:
    """Context manager timing one ``update``/``compute``/``sync`` on ``owner``.

    Returns a shared no-op when the master switch is off. The time is the
    host's: PyTorch returns before the card finishes, so on a GPU it is the
    time to enqueue the work unless the operation waits for the card.
    """
    if not OBS.enabled:
        return _NULL_SPAN
    return _OpTimer(op, type(owner).__name__, instance_label(owner))


def record_kernel_dispatch(name: str, impl: str) -> None:
    """Count one registry dispatch of entry ``name`` to ``impl``."""
    if not OBS.enabled:
        return
    KERNEL_DISPATCHES.inc(1, kernel=name, impl=impl)


def record_kernel_launch(name: str) -> None:
    """Count one launch of CUDA kernel ``name``."""
    if not OBS.enabled:
        return
    KERNEL_LAUNCHES.inc(1, kernel=name)


# ---------------------------------------------------------------------- sync payload


def tree_nbytes(tree: Any) -> int:
    """Total byte size of every array-like leaf in a state pytree (tensors,
    numpy arrays; dicts, lists and tuples walked)."""
    total = 0
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        else:
            shape = getattr(x, "shape", None)
            dtype = getattr(x, "dtype", None)
            if shape is not None and dtype is not None:
                total += int(math.prod(shape)) * int(getattr(dtype, "itemsize", 0))
    return total


def record_sync_bytes(site: str, metric: str, nbytes: int) -> None:
    """Account one HOST-level sync's state-tree payload (per-call counter + distribution)."""
    if not OBS.enabled:
        return
    SYNC_BYTES.inc(nbytes, site=site, metric=metric)
    SYNC_PAYLOAD.observe(nbytes, site=site)


def record_traced_sync_bytes(site: str, metric: str, nbytes: int) -> None:
    """Account one in-trace collective's payload, in its own counter: kept apart
    from :func:`record_sync_bytes` so the device collectives and the host
    syncs stay separate series."""
    if not OBS.enabled:
        return
    SYNC_TRACED_BYTES.inc(nbytes, site=site, metric=metric)


# ---------------------------------------------------------------------- comm plane

COMM_RAW_BYTES = REGISTRY.counter(
    "metrics_tpu_torch_comm_raw_bytes_total",
    "Cumulative pre-codec state bytes handed to the comm plane per sync site.",
)
COMM_WIRE_BYTES = REGISTRY.counter(
    "metrics_tpu_torch_comm_wire_bytes_total",
    "Cumulative post-codec bytes this process actually put on the wire per sync site.",
)
COMM_RATIO = REGISTRY.gauge(
    "metrics_tpu_torch_comm_compression_ratio",
    "raw/wire byte ratio of the most recent comm sync per site (1.0 = lossless passthrough).",
)
COMM_RETRIES = REGISTRY.counter(
    "metrics_tpu_torch_comm_retries_total",
    "Comm-plane sync attempts re-issued after a transient transport failure, per site.",
)
COMM_TIMEOUTS = REGISTRY.counter(
    "metrics_tpu_torch_comm_timeouts_total",
    "Comm-plane collectives that blew the configured deadline, per site.",
)
COMM_DEGRADATIONS = REGISTRY.counter(
    "metrics_tpu_torch_comm_degradations_total",
    "Degradation-ladder rungs taken (step=lossless_only|live_subset|local_state), per site.",
)
COMM_STALE = REGISTRY.gauge(
    "metrics_tpu_torch_comm_stale_state",
    "1 while the most recent sync at this site served LOCAL state (ladder bottom), else 0.",
)
COMM_PEER_LIVE = REGISTRY.gauge(
    "metrics_tpu_torch_comm_peer_live",
    "1 while this process's WorldView believes the labeled peer rank is live, else 0.",
)
COMM_PARTIAL_SYNCS = REGISTRY.counter(
    "metrics_tpu_torch_comm_partial_syncs_total",
    "Syncs completed over an agreed live subset of the world (the live_subset rung), per site.",
)


def record_comm_payload(site: str, raw_bytes: int, wire_bytes: int) -> None:
    """Account one comm sync's pre-codec vs on-the-wire bytes (+ ratio gauge)."""
    if not OBS.enabled:
        return
    COMM_RAW_BYTES.inc(raw_bytes, site=site)
    COMM_WIRE_BYTES.inc(wire_bytes, site=site)
    COMM_RATIO.set(raw_bytes / wire_bytes if wire_bytes else 1.0, site=site)


def record_comm_retry(site: str) -> None:
    if not OBS.enabled:
        return
    COMM_RETRIES.inc(1, site=site)


def record_comm_timeout(site: str) -> None:
    if not OBS.enabled:
        return
    COMM_TIMEOUTS.inc(1, site=site)


def record_comm_degradation(site: str, step: str) -> None:
    if not OBS.enabled:
        return
    COMM_DEGRADATIONS.inc(1, site=site, step=step)


def set_comm_stale(site: str, stale: bool) -> None:
    if not OBS.enabled:
        return
    COMM_STALE.set(1.0 if stale else 0.0, site=site)


def record_comm_peer_live(peer: int, live: bool) -> None:
    if not OBS.enabled:
        return
    COMM_PEER_LIVE.set(1.0 if live else 0.0, peer=str(peer))


def record_comm_partial_sync(site: str) -> None:
    if not OBS.enabled:
        return
    COMM_PARTIAL_SYNCS.inc(1, site=site)


def record_comm_live_set(site: str, previous: Any, agreed: Any) -> None:
    """One committed ``agree_live_set`` outcome: the membership edge lands in
    the flight ring, and an agreed set that LOST ranks relative to the
    previous commit (a real partition/death, not a rejoin) dumps a bundle."""
    if not OBS.enabled:
        return
    prev = set(previous) if previous is not None else None
    now_set = set(agreed)
    FLIGHT.record(
        "comm_live_set",
        site=site,
        previous=sorted(prev) if prev is not None else None,
        agreed=sorted(now_set),
    )
    if prev is not None and (prev - now_set):
        FLIGHT.dump(
            "live_set_shrink", site=site, lost=sorted(prev - now_set),
            agreed=sorted(now_set),
        )


def comm_span(name: str, **attrs: Any) -> Any:
    """Trace span for comm-plane internals (sync, gather, encode/decode)."""
    if not OBS.enabled:
        return _NULL_SPAN
    return TRACER.span(name, **attrs)


# ---------------------------------------------------------------------- ckpt plane

CKPT_BYTES = REGISTRY.counter(
    "metrics_tpu_torch_ckpt_bytes_total",
    "Cumulative snapshot bytes moved through the durable state plane, per site and op (write|restore).",
)
CKPT_SECONDS = REGISTRY.histogram(
    "metrics_tpu_torch_ckpt_seconds",
    "Wall time of checkpoint writes and restores (serialize + commit / read + validate + apply).",
)
CKPT_FAILURES = REGISTRY.counter(
    "metrics_tpu_torch_ckpt_failures_total",
    "Checkpoint operations that failed (and were absorbed, not raised), per site and op.",
)
CKPT_GENERATION = REGISTRY.gauge(
    "metrics_tpu_torch_ckpt_generation",
    "Most recently committed (op=write) or recovered (op=restore) snapshot generation, per site.",
)
CKPT_SKIPPED = REGISTRY.counter(
    "metrics_tpu_torch_ckpt_skipped_generations_total",
    "Snapshot generations skipped as corrupt/torn/invalid during a latest_valid recovery scan, "
    "by failure reason — each skip silently cost one generation of recovery staleness.",
)


def record_ckpt_io(
    site: str, op: str, nbytes: int, seconds: float, generation: Optional[int] = None
) -> None:
    """Account one checkpoint write/restore: bytes, latency, generation gauge."""
    if not OBS.enabled:
        return
    CKPT_BYTES.inc(nbytes, site=site, op=op)
    CKPT_SECONDS.observe(seconds, site=site, op=op)
    if generation is not None:
        CKPT_GENERATION.set(generation, site=site, op=op)


def record_ckpt_failure(site: str, op: str) -> None:
    if not OBS.enabled:
        return
    CKPT_FAILURES.inc(1, site=site, op=op)


def record_ckpt_skipped(reason: str, n: int = 1) -> None:
    """Count one generation skipped by a recovery scan (reason = exception type)."""
    if not OBS.enabled:
        return
    CKPT_SKIPPED.inc(n, reason=reason)


def ckpt_span(name: str, **attrs: Any) -> Any:
    """Trace span for durable-state-plane internals (serialize, commit, restore)."""
    if not OBS.enabled:
        return _NULL_SPAN
    return TRACER.span(name, **attrs)


# ---------------------------------------------------------------------- guard plane

GUARD_SHED = REGISTRY.counter(
    "metrics_tpu_torch_guard_shed_total",
    "Requests dropped by the overload controller (queue sojourn above target for a full interval), per engine.",
)
GUARD_QUOTA_REJECTIONS = REGISTRY.counter(
    "metrics_tpu_torch_guard_quota_rejections_total",
    "Submits refused at admission because the tenant's token bucket was empty, per engine.",
)
GUARD_DEADLINE_EXPIRED = REGISTRY.counter(
    "metrics_tpu_torch_guard_deadline_expired_total",
    "Requests whose deadline expired before dispatch (failed fast, no batch slot), per engine.",
)
GUARD_WATCHDOG_RESTARTS = REGISTRY.counter(
    "metrics_tpu_torch_guard_watchdog_restarts_total",
    "Dispatcher workers superseded and restarted after the watchdog declared them hung, per engine.",
)
GUARD_QUARANTINES = REGISTRY.counter(
    "metrics_tpu_torch_guard_quarantines_total",
    "Tenants placed under quarantine probation after repeated request failures, per engine.",
)
GUARD_BREAKER_STATE = REGISTRY.gauge(
    "metrics_tpu_torch_guard_breaker_state",
    "Circuit breaker state per engine and dependency (0=closed, 1=half-open, 2=open).",
)
GUARD_HEALTH_STATE = REGISTRY.gauge(
    "metrics_tpu_torch_guard_health_state",
    "Engine health state machine (0=SERVING, 1=DEGRADED, 2=QUARANTINED).",
)

_GUARD_EVENT_COUNTERS = {
    "shed": GUARD_SHED,
    "quota_rejections": GUARD_QUOTA_REJECTIONS,
    "deadline_expired": GUARD_DEADLINE_EXPIRED,
    "watchdog_restarts": GUARD_WATCHDOG_RESTARTS,
    "quarantines": GUARD_QUARANTINES,
}

_HEALTH_CODES = {"SERVING": 0, "DEGRADED": 1, "QUARANTINED": 2}


def record_guard_event(engine: str, kind: str, n: int = 1) -> None:
    """Count one guard decision (kind in shed|quota_rejections|deadline_expired|
    watchdog_restarts|quarantines) against its engine label.

    Tenant quarantines and watchdog restarts are flight-recorder triggering
    edges (the guard fires this exactly once per edge): each dumps one
    post-mortem bundle on top of the counter."""
    if not OBS.enabled:
        return
    _GUARD_EVENT_COUNTERS[kind].inc(n, engine=engine)
    if kind == "quarantines":
        FLIGHT.record("guard_quarantine", engine=engine)
        FLIGHT.dump("guard_quarantine", engine=engine)
    elif kind == "watchdog_restarts":
        FLIGHT.record("watchdog_restart", engine=engine)
        FLIGHT.dump("watchdog_restart", engine=engine)


def set_guard_breaker_state(engine: str, breaker: str, state_code: int) -> None:
    if not OBS.enabled:
        return
    GUARD_BREAKER_STATE.set(state_code, engine=engine, breaker=breaker)
    # the flight recorder dedups gauge refreshes into edges and dumps one
    # bundle on the transition INTO open (2)
    FLIGHT.record_breaker_state(engine, breaker, state_code)


def set_guard_health(engine: str, state: str) -> None:
    if not OBS.enabled:
        return
    GUARD_HEALTH_STATE.set(_HEALTH_CODES[state], engine=engine)


def record_health_transition(engine: str, old: str, new: str) -> None:
    """One engine health-state edge (fired beside the user's
    ``on_health_transition`` observer, exactly once per transition, outside
    the engine's locks). Entering QUARANTINED dumps a flight bundle."""
    if not OBS.enabled:
        return
    FLIGHT.record("health_transition", engine=engine, old=old, new=new)
    if new == "QUARANTINED":
        FLIGHT.dump("engine_quarantine", engine=engine, old=old)


def guard_span(name: str, **attrs: Any) -> Any:
    """Trace span for guard-plane internals (drain forming, hang handling)."""
    if not OBS.enabled:
        return _NULL_SPAN
    return TRACER.span(name, **attrs)


# ------------------------------------------------------------------- query plane

QUERY_GLOBAL = REGISTRY.counter(
    "metrics_tpu_torch_query_global_total",
    "Global (fleet-wide) queries answered by the query plane, per op (quantile|cardinality|top_k|compute) "
    "and result source (cached|merged).",
)
QUERY_CACHE_HITS = REGISTRY.counter(
    "metrics_tpu_torch_query_cache_hits_total",
    "Global query results served from the watermark-keyed cache: every contributing partition's "
    "(epoch, seq) watermark compared equal, no re-merge ran.",
)
QUERY_CACHE_MISSES = REGISTRY.counter(
    "metrics_tpu_torch_query_cache_misses_total",
    "Global queries that had to re-merge: no cached result, a watermark advanced, an epoch changed, or "
    "the live subset differed.",
)
QUERY_LEADER_READS = REGISTRY.counter(
    "metrics_tpu_torch_query_leader_reads_total",
    "Query-plane reads (rollups or watermark probes) served by a partition's WRITE LEADER instead of a "
    "follower — the number the follower-served read contract drives to zero under healthy replication, "
    "per op.",
)
QUERY_PARTITIONS_MISSING = REGISTRY.counter(
    "metrics_tpu_torch_query_partitions_missing_total",
    "Partitions a global query could not reach (headless past the retry budget, or every replica refused "
    "the staleness bound): the answer degraded to a NAMED live subset, one count per missing partition "
    "per query, per partition.",
)
QUERY_ROLLUP_SECONDS = REGISTRY.histogram(
    "metrics_tpu_torch_query_rollup_seconds",
    "Wall time of one partition rollup fold (every local tenant's mergeable state folded into one "
    "partition-level state), per engine.",
)


def record_query(op: str, *, cached: bool) -> None:
    if not OBS.enabled:
        return
    QUERY_GLOBAL.inc(1, op=op, source="cached" if cached else "merged")
    if cached:
        QUERY_CACHE_HITS.inc(1)
    else:
        QUERY_CACHE_MISSES.inc(1)


def record_query_leader_read(op: str) -> None:
    if not OBS.enabled:
        return
    QUERY_LEADER_READS.inc(1, op=op)


def record_query_partition_missing(partition: str) -> None:
    if not OBS.enabled:
        return
    QUERY_PARTITIONS_MISSING.inc(1, partition=partition)
    FLIGHT.record("query_partition_missing", partition=partition)


def record_query_rollup_seconds(engine: str, seconds: float) -> None:
    if not OBS.enabled:
        return
    QUERY_ROLLUP_SECONDS.observe(float(seconds), engine=engine)


# ---------------------------------------------------------------------- shard plane

SHARD_TENANTS = REGISTRY.gauge(
    "metrics_tpu_torch_shard_tenants",
    "Registered tenants currently owned by one shard of a ShardedEngine (consistent-hash placement), per "
    "engine and shard.",
)
SHARD_REBALANCES = REGISTRY.counter(
    "metrics_tpu_torch_shard_rebalances_total",
    "Completed shard-count resizes (hash-ring growth + tenant migration), per sharded engine.",
)


def set_shard_tenants(engine: str, shard: int, tenants: int) -> None:
    if not OBS.enabled:
        return
    SHARD_TENANTS.set(tenants, engine=engine, shard=str(shard))


def record_shard_rebalance(engine: str) -> None:
    if not OBS.enabled:
        return
    SHARD_REBALANCES.inc(1, engine=engine)


# ---------------------------------------------------------------------- tier plane

TIER_RESIDENCY = REGISTRY.gauge(
    "metrics_tpu_torch_tier_residency",
    "Tenants resident in each tier of a tiered StreamingEngine (hot = stacked device slab, warm = host-RAM "
    "mirror, cold = disk spill manifest), per engine and tier.",
)
TIER_PROMOTIONS = REGISTRY.counter(
    "metrics_tpu_torch_tier_promotions_total",
    "Tenant readmissions into the device slab, per engine and source tier (warm = host mirror restore, "
    "cold = MTCKPT1 spill-file restore).",
)
TIER_DEMOTIONS = REGISTRY.counter(
    "metrics_tpu_torch_tier_demotions_total",
    "Tenant demotions out of the device slab into the host-RAM mirror, per engine.",
)
TIER_SPILL_BYTES = REGISTRY.counter(
    "metrics_tpu_torch_tier_spill_bytes_total",
    "Bytes written to cold-tier spill files (MTCKPT1 containers), per engine.",
)
ENGINE_SLAB_BYTES = REGISTRY.gauge(
    "metrics_tpu_torch_engine_slab_bytes",
    "Device bytes held by the stacked tenant slab (live segment + window ring), per engine, dtype group and "
    "shard (empty shard label = unsharded).",
)


def set_tier_residency(engine: str, hot: int, warm: int, cold: int) -> None:
    if not OBS.enabled:
        return
    TIER_RESIDENCY.set(hot, engine=engine, tier="hot")
    TIER_RESIDENCY.set(warm, engine=engine, tier="warm")
    TIER_RESIDENCY.set(cold, engine=engine, tier="cold")


def record_tier_promotion(engine: str, source: str) -> None:
    if not OBS.enabled:
        return
    TIER_PROMOTIONS.inc(1, engine=engine, source=source)


def record_tier_demotion(engine: str) -> None:
    if not OBS.enabled:
        return
    TIER_DEMOTIONS.inc(1, engine=engine)


def record_tier_spill(engine: str, nbytes: int) -> None:
    if not OBS.enabled:
        return
    TIER_SPILL_BYTES.inc(nbytes, engine=engine)


def set_engine_slab_bytes(engine: str, dtype: str, nbytes: int, shard: str = "") -> None:
    if not OBS.enabled:
        return
    ENGINE_SLAB_BYTES.set(nbytes, engine=engine, dtype=dtype, shard=shard)


# ---------------------------------------------------------------------- repl plane

REPL_SHIPPED = REGISTRY.counter(
    "metrics_tpu_torch_repl_shipped_records_total",
    "WAL records the primary's shipper published over the replication transport, per engine.",
)
REPL_APPLIED = REGISTRY.counter(
    "metrics_tpu_torch_repl_applied_records_total",
    "Shipped WAL records a follower replayed into its local state, per engine.",
)
REPL_LAG_SEQS = REGISTRY.gauge(
    "metrics_tpu_torch_repl_lag_seqs",
    "Follower staleness in WAL records: known primary position minus applied position, per engine.",
)
REPL_LAG_SECONDS = REGISTRY.gauge(
    "metrics_tpu_torch_repl_lag_seconds",
    "Follower staleness in wall-clock seconds (now minus the primary instant the replica is "
    "known current through); -1 before bootstrap (unbounded).",
)
REPL_PROMOTIONS = REGISTRY.counter(
    "metrics_tpu_torch_repl_promotions_total",
    "Follower→primary promotions (explicit promote() or guard-quarantine failover), per engine.",
)


def record_repl_shipped(engine: str, n: int = 1) -> None:
    if not OBS.enabled:
        return
    REPL_SHIPPED.inc(n, engine=engine)


def record_repl_applied(engine: str, n: int = 1) -> None:
    if not OBS.enabled:
        return
    REPL_APPLIED.inc(n, engine=engine)


def set_repl_lag(engine: str, seqs_behind: int, seconds_behind: float) -> None:
    if not OBS.enabled:
        return
    REPL_LAG_SEQS.set(seqs_behind, engine=engine)
    REPL_LAG_SECONDS.set(-1.0 if seconds_behind == float("inf") else seconds_behind, engine=engine)


def record_repl_promotion(engine: str) -> None:
    if not OBS.enabled:
        return
    REPL_PROMOTIONS.inc(1, engine=engine)
    FLIGHT.record("repl_promotion", engine=engine)


def repl_span(name: str, **attrs: Any) -> Any:
    """Trace span for replication internals (ship tick, bootstrap, promotion)."""
    if not OBS.enabled:
        return _NULL_SPAN
    return TRACER.span(name, **attrs)


# ---------------------------------------------------------------------- cluster plane

CLUSTER_ROLE = REGISTRY.gauge(
    "metrics_tpu_torch_cluster_role",
    "This node's role in the cluster control plane: 1 leader (holds the lease), 0 follower, per node.",
)
CLUSTER_FAILOVERS = REGISTRY.counter(
    "metrics_tpu_torch_cluster_failovers_total",
    "Self-driving failovers completed by this node: lease won + promote() succeeded at the lease "
    "epoch, per node.",
)
CLUSTER_LEASE_RENEWALS = REGISTRY.counter(
    "metrics_tpu_torch_cluster_lease_renewals_total",
    "Leadership lease renewals (same epoch, deadline extended), per node.",
)
CLUSTER_SUSPICIONS = REGISTRY.counter(
    "metrics_tpu_torch_cluster_suspicions_total",
    "Failure-detector suspicion edges: a peer's heartbeat went silent past the suspect threshold "
    "(counted once per silence episode), per node.",
)

_ROLE_CODES = {"follower": 0, "leader": 1}


def set_cluster_role(node: str, role: str) -> None:
    if not OBS.enabled:
        return
    CLUSTER_ROLE.set(_ROLE_CODES.get(role, 0), node=node)


def record_cluster_failover(node: str) -> None:
    if not OBS.enabled:
        return
    CLUSTER_FAILOVERS.inc(1, node=node)
    FLIGHT.record("cluster_failover", node=node)


def record_cluster_lease_renewal(node: str) -> None:
    if not OBS.enabled:
        return
    CLUSTER_LEASE_RENEWALS.inc(1, node=node)


def record_cluster_suspicion(node: str, peer: str) -> None:
    if not OBS.enabled:
        return
    CLUSTER_SUSPICIONS.inc(1, node=node, peer=peer)
    FLIGHT.record("cluster_suspicion", node=node, peer=peer)


def record_cluster_election_failed(node: str) -> None:
    """One lost election: this node was eligible, past its backoff, raced the
    lease CAS during an actual leader vacancy — and lost. Routine contention
    against a LIVE leader never reaches this hook, so each firing is a real
    failover-stalled edge worth a bundle."""
    if not OBS.enabled:
        return
    FLIGHT.record("election_failed", node=node)
    FLIGHT.dump("election_failed", node=node)


# ------------------------------------------------------------------- partition plane

PART_ROLE = REGISTRY.gauge(
    "metrics_tpu_torch_part_role",
    "This node's role for one keyspace partition: 1 leader (holds the named lease), 0 follower, "
    "per node and partition.",
)
PART_FAILOVERS = REGISTRY.counter(
    "metrics_tpu_torch_part_failovers_total",
    "Per-partition failovers completed by this node: named lease won + promote() succeeded at the "
    "lease epoch, per node and partition.",
)
PART_MIGRATIONS = REGISTRY.counter(
    "metrics_tpu_torch_part_migrations_total",
    "Live tenant migrations completed between partitions (quarantine + snapshot handoff + "
    "destination-first commit), per node.",
)
PART_WAL_SEQ = REGISTRY.gauge(
    "metrics_tpu_torch_part_wal_seq",
    "Newest WAL position of one partition's engine — journaled seq on a leader, applied seq on a "
    "follower (-1 before the first record), per engine and partition. The query plane's watermark "
    "cache keys on (epoch, seq) pairs of exactly this number.",
)


def set_part_role(node: str, partition: str, role: str) -> None:
    if not OBS.enabled:
        return
    PART_ROLE.set(_ROLE_CODES.get(role, 0), node=node, partition=partition)


def record_part_failover(node: str, partition: str) -> None:
    if not OBS.enabled:
        return
    PART_FAILOVERS.inc(1, node=node, partition=partition)
    FLIGHT.record("part_failover", node=node, partition=partition)


def record_part_lease_lost(node: str, partition: str) -> None:
    """A held partition lease was lost (expired or conceded) and the partition
    stepped down — the per-partition analogue of the cluster plane's failover
    edge, always worth a flight-recorder mark."""
    if not OBS.enabled:
        return
    FLIGHT.record("part_lease_lost", node=node, partition=partition)


def record_part_migration(node: str) -> None:
    if not OBS.enabled:
        return
    PART_MIGRATIONS.inc(1, node=node)
    FLIGHT.record("part_migration", node=node)


def set_part_wal_seq(engine: str, partition: str, seq: int) -> None:
    if not OBS.enabled:
        return
    PART_WAL_SEQ.set(float(seq), engine=engine, partition=partition)


# ---------------------------------------------------------------------- pilot plane

PILOT_DECISIONS = REGISTRY.counter(
    "metrics_tpu_torch_pilot_decisions_total",
    "Autopilot reconcile decisions journaled, per node and decision kind "
    "(partition_hot, rebalance_planned, tier_retune, ...) — flag edges and "
    "refusals-to-act count too, so a silent controller is visibly deciding "
    "nothing rather than dead.",
)
PILOT_MIGRATIONS = REGISTRY.counter(
    "metrics_tpu_torch_pilot_migrations_total",
    "Tenant migrations the autopilot EXECUTED (a subset of "
    "metrics_tpu_torch_part_migrations_total, which also counts operator-driven "
    "moves), per node.",
)
PILOT_PAUSED = REGISTRY.gauge(
    "metrics_tpu_torch_pilot_paused",
    "1 while this node's autopilot actuation is frozen (pause() or "
    "enabled=False) — the kill switch, scrapeable.",
)


def record_pilot_decision(node: str, kind: str) -> None:
    if not OBS.enabled:
        return
    PILOT_DECISIONS.inc(1, node=node, kind=kind)


def record_pilot_migration(node: str) -> None:
    if not OBS.enabled:
        return
    PILOT_MIGRATIONS.inc(1, node=node)
    FLIGHT.record("pilot_migration", node=node)


def set_pilot_paused(node: str, paused: bool) -> None:
    if not OBS.enabled:
        return
    PILOT_PAUSED.set(1 if paused else 0, node=node)


def record_pilot_lease_won(node: str, epoch: int) -> None:
    """This node became the fleet's controller (won the pilot named lease)."""
    if not OBS.enabled:
        return
    FLIGHT.record("pilot_lease_won", node=node, epoch=epoch)


def record_pilot_lease_lost(node: str) -> None:
    if not OBS.enabled:
        return
    FLIGHT.record("pilot_lease_lost", node=node)


def record_pilot_action_failed(node: str, kind: str) -> None:
    """An actuator action raised — always a bundle-worthy edge: the journal
    says what was attempted, the bundle preserves the fleet state it was
    attempted against."""
    if not OBS.enabled:
        return
    FLIGHT.record("pilot_action_failed", node=node, action=kind)
    FLIGHT.dump("pilot_action_failed", node=node, action=kind)


# ---------------------------------------------------------------------- engine


def engine_span(name: str, **attrs: Any) -> Any:
    """Trace span for engine internals (dispatch, inline apply, replay, tier moves)."""
    if not OBS.enabled:
        return _NULL_SPAN
    return TRACER.span(name, **attrs)
