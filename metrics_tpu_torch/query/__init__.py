"""Global query plane — fleet-wide analytics as a first-class read path
(port of ``metrics_tpu/query``).

One :class:`GlobalQuery` over a partitioned client answers "what is the p99
across ALL tenants" with P rollup reads instead of a million per-tenant
scatters: each partition folds its local tenants into one mergeable state
(:mod:`~metrics_tpu_torch.query.rollup`), the rollups reduce through a
deterministic merge tree (:mod:`~metrics_tpu_torch.query.tree`), and results are
cached under per-partition WAL watermarks (:mod:`~metrics_tpu_torch.query.cache`)
so repeat queries revalidate with a seq compare instead of a re-merge.
"""

from metrics_tpu_torch.query.cache import CachedGlobal, WatermarkCache, watermark_compatible
from metrics_tpu_torch.query.errors import (
    NoLivePartitionsError,
    PartialResultError,
    RollupUnsupported,
)
from metrics_tpu_torch.query.global_query import GlobalQuery
from metrics_tpu_torch.query.report import GlobalResult, PartitionReport, QueryReport
from metrics_tpu_torch.query.rollup import (
    PartitionRollup,
    fold_slab,
    fold_states,
    merge_folds,
)
from metrics_tpu_torch.query.tree import merge_tree

__all__ = [
    "CachedGlobal",
    "GlobalQuery",
    "GlobalResult",
    "NoLivePartitionsError",
    "PartialResultError",
    "PartitionReport",
    "PartitionRollup",
    "QueryReport",
    "RollupUnsupported",
    "WatermarkCache",
    "fold_slab",
    "fold_states",
    "merge_folds",
    "merge_tree",
    "watermark_compatible",
]
