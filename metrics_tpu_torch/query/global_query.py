"""GlobalQuery — fleet-wide analytics over every partition, as one read path
(port of ``metrics_tpu/query/global_query.py``).

The scatter loop this plane replaces asked every partition leader for every
tenant and re-aggregated client-side. GlobalQuery instead asks each
partition for ONE rollup (all local tenants pre-folded, servable by a
follower), merges the rollups through a deterministic multi-hop tree, and
stamps the result with every contributor's ``(epoch, seq)`` WAL watermark:

- a partition that cannot serve (headless past the retry budget, every
  replica refusing its staleness bound) is NAMED in
  ``QueryReport.partitions_missing`` — the answer degrades to an agreed
  live subset, never a silent undercount and never a deadlock;
- repeat queries revalidate by watermark compare (two ints per partition,
  follower-servable) and reuse the cached merge until some partition's
  journal actually advances — see :mod:`metrics_tpu_torch.query.cache` for the
  validity argument;
- with ``prefer="replica"`` (the default) both rollups and watermark probes
  are served by followers under the bounded-staleness contract, so a
  dashboard read storm never touches a write leader
  (``metrics_tpu_torch_query_leader_reads_total`` counts the exceptions).

The cache stores the merged global STATE, not a single scalar: one cached
merge answers ``quantile(m, 0.5)``, ``quantile(m, 0.99)`` and
``cardinality(m)`` alike, because the expensive part — rollup folds and the
merge tree — is identical for all of them.

The client is the partition plane's
:class:`~metrics_tpu_torch.part.PartitionedClient`, or anything duck-typed like
it: a ``pmap`` (``partitions``, ``name_of(pid)``) and ``rollup(pid, prefer=,
window=)`` / ``wal_watermark(pid, prefer=, retries=)`` returning ``(result,
node, is_leader)``.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, Hashable, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.cluster.errors import NoLeaderError
from metrics_tpu_torch.engine.runtime import EngineClosed
from metrics_tpu_torch.guard.errors import EngineQuarantined
from metrics_tpu_torch.obs import instrument as _obs
from metrics_tpu_torch.query.cache import CachedGlobal, WatermarkCache, watermark_compatible
from metrics_tpu_torch.query.errors import NoLivePartitionsError, PartialResultError
from metrics_tpu_torch.query.report import GlobalResult, PartitionReport, QueryReport
from metrics_tpu_torch.query.rollup import PartitionRollup
from metrics_tpu_torch.query.tree import merge_tree
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

__all__ = ["GlobalQuery"]

# "this partition cannot contribute right now": routing exhausted every node
# (headless, staleness-refused everywhere, dead handles) or the only engine
# is wedged/closed. Anything else — RollupUnsupported, a caller error — is a
# bug to surface, not a partition to degrade away.
_MISSING = (NoLeaderError, EngineQuarantined, EngineClosed)


def _metric_key(metric: Any) -> Tuple[Any, ...]:
    """State-shape fingerprint: two metrics whose states are interchangeable
    (same names, shapes, dtypes) share cached merges — the cached state came
    from the ENGINES, the metric argument only interprets it."""
    init = metric.init_state()
    leaves: List[Tuple[Any, ...]] = []
    for name in sorted(init):
        v = init[name]
        if isinstance(v, list):
            leaves.append((name, "list"))
        else:
            arr = torch.as_tensor(v)
            leaves.append((name, tuple(arr.shape), str(arr.dtype)))
    return (type(metric).__name__, tuple(leaves))


class GlobalQuery:
    """Fleet-wide reads over a partitioned client
    (:class:`~metrics_tpu_torch.part.PartitionedClient`, or any client of its
    interface).

    Args:
        client: the partitioned client (its per-partition routers serve the
            rollup and watermark reads with the routing contract's redirect +
            backoff ladder).
        prefer: ``"replica"`` (default) serves rollups/probes from followers
            under bounded staleness; ``"leader"`` reads the writable truth.
        fan_in: merge-tree arity (see :func:`metrics_tpu_torch.query.tree.merge_tree`).
        cache: a shared :class:`WatermarkCache` (one is built when omitted).
        cache_capacity: LRU capacity of the built-in cache.
        require_full: raise :class:`PartialResultError` instead of degrading
            to a named subset when any partition is missing.
        probe_retries: router retry budget for watermark probes (kept small:
            a failed probe falls back to a full re-merge, which is correct —
            just slower — so the hit path should not inherit the write
            path's full patience).
    """

    def __init__(
        self,
        client: Any,
        *,
        prefer: str = "replica",
        fan_in: int = 4,
        cache: Optional[WatermarkCache] = None,
        cache_capacity: int = 32,
        require_full: bool = False,
        probe_retries: int = 1,
    ) -> None:
        if prefer not in ("leader", "replica"):
            raise ValueError(f"prefer must be 'leader' or 'replica', got {prefer!r}")
        self._client = client
        self._prefer = prefer
        self._fan_in = int(fan_in)
        self._cache = cache if cache is not None else WatermarkCache(cache_capacity)
        self._require_full = bool(require_full)
        self._probe_retries = int(probe_retries)

    # ------------------------------------------------------------------ public ops

    def compute(self, metric: Any, *, window: bool = False) -> GlobalResult:
        """Global value of any reducible-state metric (all tenants merged)."""
        state, report = self._global_state(metric, "compute", window)
        return GlobalResult(metric.compute_from(state), report)

    def quantile(self, metric: Any, q: Union[float, Any], *, window: bool = False) -> GlobalResult:
        """Global quantile(s) ``q`` from a merged DDSketch state."""
        if not hasattr(metric, "quantile_from"):
            raise MetricsTPUUserError(
                f"quantile() needs a quantile sketch (a metric with `quantile_from`), "
                f"got {type(metric).__name__}"
            )
        state, report = self._global_state(metric, "quantile", window)
        return GlobalResult(metric.quantile_from(state, q), report)

    def cardinality(self, metric: Any, *, window: bool = False) -> GlobalResult:
        """Global distinct count from a merged HLL state."""
        state, report = self._global_state(metric, "cardinality", window)
        return GlobalResult(metric.compute_from(state), report)

    def top_k(self, metric: Any, k: Optional[int] = None, *, window: bool = False) -> GlobalResult:
        """Global heavy hitters from a merged CMS + ledger state."""
        if not hasattr(metric, "topk_from"):
            raise MetricsTPUUserError(
                f"top_k() needs a heavy-hitters sketch (a metric with `topk_from`), "
                f"got {type(metric).__name__}"
            )
        state, report = self._global_state(metric, "top_k", window)
        return GlobalResult(metric.topk_from(state, k), report)

    @property
    def cache(self) -> WatermarkCache:
        return self._cache

    # ------------------------------------------------------------------ machinery

    def _partition_ids(self) -> List[int]:
        return list(range(self._client.pmap.partitions))

    def _global_state(
        self, metric: Any, op: str, window: bool
    ) -> Tuple[Dict[str, Any], QueryReport]:
        key: Hashable = (bool(window), _metric_key(metric))
        cached = self._cache.get(key)
        if cached is not None and self._revalidate(cached, op):
            _obs.record_query(op, cached=True)
            return cached.state, replace(cached.report, op=op, cache_hit=True)
        return self._merge(metric, op, window, key)

    def _revalidate(self, cached: CachedGlobal, op: str) -> bool:
        """Watermark compare, not a re-merge: True iff every contributing
        partition's probed stamp is compatible AND no previously-missing
        partition has come back (a returned partition must be re-admitted
        into the merge, so its recovery is a miss by design)."""
        names = {self._client.pmap.name_of(pid): pid for pid in self._partition_ids()}
        for pname, stamp in cached.watermarks.items():
            pid = names.get(pname)
            if pid is None:
                return False  # the partition map itself changed shape
            try:
                wm, _node, is_leader = self._client.wal_watermark(
                    pid, prefer=self._prefer, retries=self._probe_retries
                )
            except _MISSING:
                return False  # can't vouch for the stamp: re-merge (and name it)
            if is_leader:
                _obs.record_query_leader_read(op)
            if not watermark_compatible(stamp, wm):
                return False
        for pname in cached.missing:
            pid = names.get(pname)
            if pid is None:
                return False
            try:
                _wm, _node, is_leader = self._client.wal_watermark(
                    pid, prefer=self._prefer, retries=0
                )
            except _MISSING:
                continue  # still gone: the cached subset is still the live one
            if is_leader:
                _obs.record_query_leader_read(op)
            return False  # it came back — re-merge to re-admit it
        return True

    def _merge(
        self, metric: Any, op: str, window: bool, key: Hashable
    ) -> Tuple[Dict[str, Any], QueryReport]:
        rollups: List[PartitionRollup] = []
        part_reports: List[PartitionReport] = []
        missing: List[str] = []
        for pid in self._partition_ids():
            pname = self._client.pmap.name_of(pid)
            try:
                ru, node, is_leader = self._client.rollup(
                    pid, prefer=self._prefer, window=window
                )
            except _MISSING as exc:
                missing.append(pname)
                part_reports.append(
                    PartitionReport(partition=pname, error=f"{type(exc).__name__}: {exc}")
                )
                _obs.record_query_partition_missing(pname)
                continue
            if is_leader:
                _obs.record_query_leader_read(op)
            rollups.append(ru)
            part_reports.append(
                PartitionReport(
                    partition=pname,
                    node=node,
                    follower=ru.follower,
                    watermark=ru.watermark,
                    tenants=ru.tenants,
                    staleness_seqs=ru.staleness_seqs,
                    staleness_s=ru.staleness_s,
                )
            )
        if not rollups:
            raise NoLivePartitionsError(
                "global query could not reach ANY partition — nothing to degrade to. "
                + "; ".join(f"{r.partition}: {r.error}" for r in part_reports)
            )
        if missing and self._require_full:
            raise PartialResultError(
                f"global query is missing partitions {tuple(missing)!r} and "
                "require_full=True"
            )
        # empty partitions are excluded from the MERGE, not the report: their
        # state is the reduction identity, but callable reductions (topk_merge)
        # canonicalize representation on contact, so folding identities in
        # would break bit-identity with the centralized oracle for singleton
        # merges. Their watermarks still gate the cache — a tenant landing on
        # an empty partition advances its seq and invalidates.
        state, hops = merge_tree(
            metric, [r.state for r in rollups if r.tenants > 0], fan_in=self._fan_in
        )
        tenants = sum(r.tenants for r in rollups)
        report = QueryReport(
            op=op,
            partitions=tuple(part_reports),
            partitions_missing=tuple(missing),
            watermarks={r.partition: r.watermark for r in rollups},
            cache_hit=False,
            merge_hops=hops,
            tenants=tenants,
        )
        self._cache.put(
            key,
            CachedGlobal(
                state=state,
                watermarks=dict(report.watermarks),
                missing=tuple(missing),
                report=report,
                tenants=tenants,
            ),
        )
        _obs.record_query(op, cached=False)
        return state, report
