"""Streaming metric engine — async micro-batched, multi-tenant metric serving
(port of ``metrics_tpu/engine`` with its durable state plane; without the guard,
replication and tier planes).

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

__all__ = [
    "DEFAULT_BUCKETS",
    "BucketConfig",
    "CheckpointConfig",
    "EagerKeyedState",
    "EngineBackpressure",
    "EngineClosed",
    "EngineTelemetry",
    "KeyedState",
    "StreamingEngine",
    "choose_bucket",
    "inspect_request",
    "pad_micro_batch",
    "tune_buckets",
]
