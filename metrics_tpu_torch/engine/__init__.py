"""Streaming metric engine — async micro-batched, multi-tenant metric serving
(port of ``metrics_tpu/engine`` with its durable state, guard, tier and
replication planes).

Turns any ``Metric`` / ``MetricCollection`` into a service::

    from metrics_tpu_torch.engine import CheckpointConfig, StreamingEngine

    engine = StreamingEngine(metric, buckets=(8, 64, 256), max_queue=1024,
                             checkpoint=CheckpointConfig(directory="/var/ckpt"))  # optional
    fut = engine.submit(client_id, preds, target)   # non-blocking; Future receipt
    value = engine.compute(client_id)               # flush + per-tenant compute
    engine.close()

Layout: ``bucketing.py`` (shape-bucketed padding), ``runtime.py`` (bounded-queue
dispatcher, one CUDA graph per micro-batch shape, backpressure and degradation,
snapshots, the WAL and recovery),
``stream.py`` (stacked multi-tenant keyed state and sliding windows),
``telemetry.py`` (counters, occupancy, p50/p99 latency in the port's obs registry).
Overload and abuse protection is the guard plane (``guard=GuardConfig(...)``,
:mod:`metrics_tpu_torch.guard`); million-tenant residency is the tier plane
(``tier=TierConfig(...)``, :mod:`metrics_tpu_torch.tier`); read replicas and
failover are the replication plane (``replication=ReplConfig(...)``,
:mod:`metrics_tpu_torch.repl`).
"""

from metrics_tpu_torch.engine.bucketing import (
    DEFAULT_BUCKETS,
    BucketConfig,
    choose_bucket,
    inspect_request,
    pad_micro_batch,
    tune_buckets,
)
from metrics_tpu_torch.engine.runtime import CheckpointConfig, EngineBackpressure, EngineClosed, StreamingEngine
from metrics_tpu_torch.engine.stream import EagerKeyedState, KeyedState
from metrics_tpu_torch.engine.telemetry import EngineTelemetry
from metrics_tpu_torch.guard import (
    DeadlineExceeded,
    EngineQuarantined,
    GuardConfig,
    GuardRejected,
    QuotaExceeded,
    RequestShed,
    TenantQuarantined,
)
from metrics_tpu_torch.repl.config import ReplConfig, ReplicaLag
from metrics_tpu_torch.repl.errors import NotPrimaryError, NotPromotableError, StalenessExceeded
from metrics_tpu_torch.tier import TierConfig

__all__ = [
    "DEFAULT_BUCKETS",
    "BucketConfig",
    "CheckpointConfig",
    "DeadlineExceeded",
    "EagerKeyedState",
    "EngineBackpressure",
    "EngineClosed",
    "EngineQuarantined",
    "EngineTelemetry",
    "GuardConfig",
    "GuardRejected",
    "KeyedState",
    "NotPrimaryError",
    "NotPromotableError",
    "QuotaExceeded",
    "ReplConfig",
    "ReplicaLag",
    "RequestShed",
    "StalenessExceeded",
    "StreamingEngine",
    "TenantQuarantined",
    "TierConfig",
    "choose_bucket",
    "inspect_request",
    "pad_micro_batch",
    "tune_buckets",
]
