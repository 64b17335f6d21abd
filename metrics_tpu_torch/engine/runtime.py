"""StreamingEngine — async micro-batched, multi-tenant metric serving
(port of ``metrics_tpu/engine/runtime.py``, the core without the planes).

The pure functional core (``Metric.update_state`` / ``compute_from`` /
``merge_states``) is the substrate: state is an explicit tree of tensors and
updates never write into the state they are given, so a serving process does not
have to serialize clients through a lock or pay one launch sequence per request:

    client threads ── submit(key, *arrays) ──► bounded queue ──► dispatcher thread
        │                                         │ coalesce + shape-bucket (bucketing.py)
        │  Future (receipt)  ◄─────────────────── │ ONE CUDA-graph replay per micro-batch:
        │                                         ▼ masked scan over rows, in place
        └── compute(key) ◄── flush ── keyed stacked state (stream.py), all tenants

Dispatch semantics are **per-row streaming updates in submission order**: the
micro-batch kernel scans the coalesced rows, applying the metric's own
``update_state`` to each tenant's slice and keeping padded rows away from every
tenant's state. For the supported metric class (fixed-shape tensor states) this is
exactly the sequential per-request semantics, bit for bit. On the card each
micro-batch is one replay of a CUDA graph, captured once per (request signature,
bucket, tenant capacity) — the key the JAX package compiles on — so the graph
cache is bounded by ``len(buckets) × log2(capacity)`` per signature. On the CPU the
same scan runs as a plain loop (nothing to capture). A receipt means "your rows are
in the state": the dispatcher synchronises its stream before futures resolve.

Degradation ladder (each step is correctness-preserving, only slower; each step down
is counted in telemetry):

1. fused micro-batched dispatch (the hot path);
2. a metric whose update cannot be captured (it reads a value on the host, say)
   demotes permanently to eager per-request ``update_state`` on the dispatcher
   thread, on the same device (``fused_fallbacks``);
3. if the dispatcher thread itself dies, the engine completes its in-flight work
   synchronously and every later ``submit`` runs inline on the caller's thread
   (``inline_dispatches``) — no request is ever silently lost.

Backpressure at a full queue follows ``policy``: ``"block"`` (wait for space),
``"drop"`` (raise :class:`EngineBackpressure` immediately), ``"timeout"`` (wait up to
``submit_timeout`` seconds, then raise).

One dispatcher thread owns one CUDA stream for every host-to-device copy, replay and
synchronise. Every access to the slab happens under the dispatch lock, and every
holder of that lock synchronises the stream it used before releasing it, so no
reader ever races a replay.

Durable state (``checkpoint=CheckpointConfig(...)``): a background writer persists
every tenant's state as an MTCKPT1 snapshot (:mod:`metrics_tpu_torch.ckpt`), and a
WAL journals each committed micro-batch as one chunk record, written from the host
arrays the batch was built from, after its replay is synchronised and before its
futures resolve; eager and inline requests are journaled one record each, and
window rotations, resets and tenant evictions as markers, in order. A restart
restores the newest valid snapshot and replays the WAL after it through the
engine's own bucket graphs, so the recovered state is the lost engine's, bit for
bit, on the device kind that journaled it. Snapshots and WAL directories are the
JAX package's format: either package recovers from what the other wrote.

Not ported yet: the guard, replication and tier planes (``guard=``,
``replication=``, ``tier=``, ROADMAP A.7), and with them trace contexts, the flight
recorder, dispatcher restarts, ``export_tenant``, ``import_tenant`` and the WAL's
demote and promote records; ``compute(sync=True)`` (A.8); ``rollup`` (A.9). Each
raises ``NotImplementedError`` naming its item. Reads compute eagerly from a copy of
the tenant's state (the JAX package's jitted read path is not captured yet, so
``read_jit_fallbacks`` stays 0).
"""

from __future__ import annotations

import os
import pickle
import struct
import threading
import time
import warnings
from concurrent.futures import Future
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Hashable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map

from metrics_tpu_torch.ckpt.format import _dtype_from_name
from metrics_tpu_torch.ckpt.restore import dtype_name, host_tree
from metrics_tpu_torch.ckpt.store import RequestJournal, SnapshotStore
from metrics_tpu_torch.ckpt.writer import AsyncCheckpointer
from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.engine.bucketing import (
    DEFAULT_BUCKETS,
    BucketConfig,
    Signature,
    _as_numpy,
    choose_bucket,
    as_request_tensor,
    inspect_request,
    narrow_name,
    normalize_buckets,
    pad_micro_batch,
    split_rows,
)
from metrics_tpu_torch.engine.stream import EagerKeyedState, KeyedState, _clone_tree
from metrics_tpu_torch.engine.telemetry import EngineTelemetry
from metrics_tpu_torch.kernels import launch_counts
from metrics_tpu_torch.kernels.engine_scan import masked_scan_update
from metrics_tpu_torch.metric import Metric, _as_state_tensor
from metrics_tpu_torch.obs import instrument as _obs
from metrics_tpu_torch.utils.checks import traced
from metrics_tpu_torch.utils.device import resolve_device
from metrics_tpu_torch.utils.graphs import capture
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

_POLICIES = ("block", "drop", "timeout")
_WAL_FLUSH = ("none", "flush", "fsync")
_WAL_FSYNC = ("never", "commit", "interval")

# the planes that wait for a later slice, and their ROADMAP items
_PLANES = (("guard", "A.7"), ("replication", "A.7"), ("tier", "A.7"))

# WAL record encoding: the JAX package's, byte for byte, so either package replays
# the other's journal. Hand-rolled rather than pickled, because encoding rides the
# dispatcher's critical path:
#
# - b"C" CHUNK records — the fused hot path. One record per dispatched micro-batch
#   holding the PADDED columns + key_ids + mask exactly as the kernel saw them
#   (numpy, from the host arrays the batch was built from), plus pickled key
#   mappings for any slot ids this journal has not introduced yet. Replay runs the
#   record through the engine's own bucket graph, reproducing the per-row
#   accumulation bit for bit on the device kind that journaled it.
# - b"R" REQUEST records — eager metrics, degraded/inline submits, and the eager
#   retry after a failed capture: pickled key + raw dtype/shape/bytes per arg,
#   applied whole-request on replay (as those paths applied it originally).
# - b"Z" RESET / b"W" ROTATE records — single-byte markers for the state
#   transitions that are not submits, journaled in order with the chunks.
# - b"T" RETIRE records (slot + key) — ``evict_tenant``, journaled before the slot
#   returns to the free list, so replay reproduces retire-then-reuse in order.
# - b"D" DEMOTE / b"P" PROMOTE records come from the JAX package's tier plane; the
#   port replays them once that plane is ported (ROADMAP A.7) and raises until then.
#
# The JAX package may append a trace-context trailer (17 bytes per traced request)
# to R and C records; the decoders stop at the positional body and ignore it, as
# trace contexts come with A.7.

_WAL_U32 = struct.Struct("<I")


def _enc_array(parts: List[bytes], a: np.ndarray) -> None:
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("="))
    name = a.dtype.name.encode()
    parts.append(bytes((len(name), a.ndim)))
    parts.append(name)
    if a.ndim:
        parts.append(struct.pack(f"<{a.ndim}q", *a.shape))
    parts.append(a.tobytes())


def _dec_array(payload: bytes, off: int) -> Tuple[np.ndarray, int]:
    nlen, ndim = payload[off], payload[off + 1]
    off += 2
    dtype = _dtype_from_name(payload[off : off + nlen].decode())
    off += nlen
    shape = struct.unpack_from(f"<{ndim}q", payload, off) if ndim else ()
    off += 8 * ndim
    count = int(np.prod(shape)) if ndim else 1
    arr = np.frombuffer(payload, dtype, count, off).reshape(shape)
    return arr, off + count * dtype.itemsize


def _encode_request_record(key_bytes: bytes, args: Tuple[Any, ...]) -> bytes:
    parts = [b"R", _WAL_U32.pack(len(key_bytes)), key_bytes, bytes((len(args),))]
    for a in args:
        _enc_array(parts, _as_numpy(a))
    return b"".join(parts)


def _decode_request_record(payload: bytes) -> Tuple[Hashable, Tuple[np.ndarray, ...]]:
    (klen,) = _WAL_U32.unpack_from(payload, 1)
    off = 1 + _WAL_U32.size + klen
    key = pickle.loads(payload[1 + _WAL_U32.size : off])
    nargs = payload[off]
    off += 1
    args = []
    for _ in range(nargs):
        arr, off = _dec_array(payload, off)
        args.append(arr)
    return key, tuple(args)  # bytes past ``off``: the JAX package's trace trailer


def _encode_chunk_record(
    new_slots: List[Tuple[int, bytes]],
    key_ids: np.ndarray,
    mask: np.ndarray,
    columns: Sequence[np.ndarray],
) -> bytes:
    parts = [b"C", struct.pack("<H", len(new_slots))]
    for slot, key_bytes in new_slots:
        parts.append(_WAL_U32.pack(slot))
        parts.append(_WAL_U32.pack(len(key_bytes)))
        parts.append(key_bytes)
    parts.append(bytes((len(columns),)))
    _enc_array(parts, key_ids)
    _enc_array(parts, mask)
    for col in columns:
        _enc_array(parts, col)
    return b"".join(parts)


def _encode_tier_record(kind: bytes, slot: int, key_bytes: bytes) -> bytes:
    """One residency-transition WAL record; the port writes only b"T"."""
    return b"".join([kind, _WAL_U32.pack(slot), _WAL_U32.pack(len(key_bytes)), key_bytes])


def _decode_tier_record(payload: bytes) -> Tuple[int, Hashable]:
    (slot,) = _WAL_U32.unpack_from(payload, 1)
    (klen,) = _WAL_U32.unpack_from(payload, 5)
    return slot, pickle.loads(payload[9 : 9 + klen])


def _numpy_leaf(x: Any) -> bool:
    return isinstance(x, (np.ndarray, np.generic))


def _device_tree(tree: Any, device: torch.device) -> Any:
    """A snapshot's numpy tree as tensors on ``device`` (containers rebuilt)."""
    if _numpy_leaf(tree):
        return _as_state_tensor(tree, device)
    if isinstance(tree, dict):
        return {k: _device_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_device_tree(v, device) for v in tree)
    return tree


def _leaves_like(tree: Any, like: Any) -> List[Any]:
    """The leaves of ``tree`` in the flattened order of ``like``, matched by dict
    key and list index, not by order: the JAX package writes dicts with sorted
    keys. Raises ``ValueError`` where the structures differ."""
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            raise ValueError("stacked state structure does not match the live metric")
        return [leaf for k in like for leaf in _leaves_like(tree[k], like[k])]
    if isinstance(like, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(like):
            raise ValueError("stacked state structure does not match the live metric")
        return [leaf for t, l in zip(tree, like) for leaf in _leaves_like(t, l)]
    if not _numpy_leaf(tree):
        raise ValueError(f"stacked state leaf is a {type(tree).__name__}, not an array")
    return [tree]


# Engine snapshot payload schema. Engine snapshots are operational (serving
# continuity), not archival: a version bump invalidates old generations — the
# recovery scan just skips them — rather than migrating them.
_ENGINE_SCHEMA_VERSION = 1


@dataclass(frozen=True)
class CheckpointConfig:
    """Durable-state-plane wiring for one :class:`StreamingEngine` (the JAX
    package's fields and defaults).

    ``directory`` holds the generational snapshots AND the WAL segments. A
    background :class:`~metrics_tpu_torch.ckpt.writer.AsyncCheckpointer` persists
    the full multi-tenant state every ``interval_s`` seconds (the dispatcher hands
    it a consistent host copy between micro-batches — the submit hot path never
    blocks on IO). The WAL journals each committed fused micro-batch as ONE chunk
    record and each eager/inline request individually, so a restart recovers the
    newest valid snapshot and replays exactly the work acknowledged after it, in
    the original per-row order. ``policy=None`` keeps snapshots lossless.

    ``wal_flush``: per-drained-batch durability of the journal — ``"none"``
    (OS-buffered; flushed at rotation/close), ``"flush"`` (python-level flush,
    the default), ``"fsync"`` (fsync per batch — strongest, slowest).

    ``wal_fsync``: an orthogonal fsync *policy* on top of ``wal_flush`` —
    ``"never"`` (the default), ``"commit"`` (fsync after every journal append: a
    committed record survives power loss, not just process death), or
    ``"interval"`` (fsync at most every ``wal_fsync_interval_s`` seconds).

    ``rank``/``world`` name this process's files in a multi-process layout;
    ``resume=False`` starts empty over an existing directory.
    """

    directory: str
    interval_s: float = 30.0
    retain: int = 3
    policy: Optional[Any] = None  # comm.CodecPolicy; None = lossless
    wal: bool = True
    wal_flush: str = "flush"
    wal_fsync: str = "never"
    wal_fsync_interval_s: float = 0.5
    resume: bool = True
    durable: bool = True
    rank: int = 0
    world: int = 1


class EngineClosed(MetricsTPUUserError):
    """submit() after close()."""


class EngineBackpressure(MetricsTPUUserError):
    """Request rejected at a full queue (drop policy, or timeout policy expiry)."""


class _FusedUnsupported(Exception):
    """Internal: the metric's update cannot run inside the micro-batch kernel."""


class _Request:
    __slots__ = ("key", "slot", "args", "rows", "signature", "future", "t_submit", "rows_done", "seq")

    def __init__(self, key: Hashable, slot: Optional[int], args: Tuple[Any, ...],
                 rows: int, signature: Signature, future: "Future", t_submit: float) -> None:
        self.key = key
        self.slot = slot
        self.args = args
        self.rows = rows
        self.signature = signature
        self.future = future
        # stamped at submit() ENTRY, before any backpressure wait — the latency
        # percentiles must include the stall they exist to surface
        self.t_submit = t_submit
        # rows already committed to the state (fused chunks commit incrementally, so a
        # mid-batch fused→eager demotion must not re-apply them)
        self.rows_done = 0
        self.seq: Optional[int] = None  # WAL seq of this request's own record, once journaled


def _component_metrics(metric: Any) -> List[Metric]:
    if isinstance(metric, MetricCollection):
        return list(metric._modules.values())
    return [metric]


class _LoopKernel:
    """One micro-batch kernel on the CPU: the masked scan as a plain loop over a
    copy of the slab, committed in place when every row succeeded (a failing row
    leaves the slab as it was, as a failed JAX trace does). The loop stands for
    the JAX package's traced scan, so it skips value checks as a trace does."""

    def __init__(self, update_state: Callable) -> None:
        self._update_state = update_state

    def __call__(self, keyed: KeyedState, key_ids: torch.Tensor, mask: torch.Tensor,
                 columns: Sequence[torch.Tensor]) -> None:
        work = _clone_tree(keyed.stacked)
        try:
            with traced():
                masked_scan_update(self._update_state, work, key_ids, mask, columns)
        except Exception as exc:  # noqa: BLE001 — routed to the eager retry (see _process)
            raise _FusedUnsupported(repr(exc)) from exc
        keyed.commit(work)


class _GraphKernel:
    """One micro-batch kernel on the card: the masked scan over ``bucket`` rows
    captured as one CUDA graph that reads static input buffers and writes the
    engine's slab in place.

    First call: the inputs are copied into the static buffers, the scan runs once
    on a scratch copy of the slab on the engine's stream (that builds the kernels
    and settles the caching allocator, and surfaces an ordinary error outside any
    capture), then the scan is captured on the slab itself into the engine's
    shared graph pool and replayed. Later calls copy the inputs into the static
    buffers and replay. An error in the warm-up or the capture raises
    :class:`_FusedUnsupported`. The warm-up and the capture run
    :func:`~metrics_tpu_torch.utils.checks.traced`: the warm-up skips the value
    checks that the replays skip, so a request is judged the same before its
    graph exists and after.

    The wrappers' launch counters advance once while the graph is captured and
    never at a replay: ``captured`` holds that advance by kernel name, and
    ``captured × replays`` is what the graph launched.
    """

    def __init__(self, update_state: Callable, stream: torch.cuda.Stream, pool: Any) -> None:
        self._update_state = update_state
        self._stream = stream
        self._pool = pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._static: List[torch.Tensor] = []
        self.warmup_ms = 0.0
        self.capture_ms = 0.0
        self.pool_bytes = 0  # growth of the allocator's reserved memory during the capture
        self.captured: Dict[str, int] = {}
        self.replays = 0

    def __call__(self, keyed: KeyedState, key_ids: torch.Tensor, mask: torch.Tensor,
                 columns: Sequence[torch.Tensor]) -> None:
        if self.graph is None:
            self._capture(keyed, key_ids, mask, columns)
        else:
            for dst, src in zip(self._static, (key_ids, mask, *columns)):
                dst.copy_(src)
        self.graph.replay()
        self.replays += 1

    def _capture(self, keyed: KeyedState, key_ids: torch.Tensor, mask: torch.Tensor,
                 columns: Sequence[torch.Tensor]) -> None:
        self._static = [t.clone() for t in (key_ids, mask, *columns)]
        kids, msk, *cols = self._static
        device = kids.device
        try:
            with traced():
                t0 = time.perf_counter()
                masked_scan_update(self._update_state, _clone_tree(keyed.stacked), kids, msk, cols)
                self._stream.synchronize()
                t1 = time.perf_counter()
                torch.cuda.empty_cache()  # as the capture's own start does, so the baseline is the capture's
                reserved = torch.cuda.memory_reserved(device)
                before = launch_counts()
                graph, _ = capture(
                    lambda: masked_scan_update(self._update_state, keyed.stacked, kids, msk, cols), self._stream,
                    self._pool,
                )
                t2 = time.perf_counter()
        except Exception as exc:  # noqa: BLE001 — a host read, an illegal op in capture, a bad request
            raise _FusedUnsupported(repr(exc)) from exc
        self.captured = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
        self.warmup_ms = (t1 - t0) * 1e3
        self.capture_ms = (t2 - t1) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.graph = graph


class StreamingEngine:
    """Serve a ``Metric`` or ``MetricCollection`` to many concurrent clients.

    Args:
        metric_or_collection: the logical metric. The engine works on a private clone,
            so the caller's instance stays free for direct use.
        buckets: micro-batch row sizes the engine captures graphs for — a sequence or a
            :class:`~metrics_tpu_torch.engine.bucketing.BucketConfig`. The graph cache
            after warm-up is bounded by this set.
        max_queue: bound on queued (not yet dispatched) requests.
        policy: backpressure policy at a full queue — "block" | "drop" | "timeout".
        submit_timeout: seconds a "timeout"-policy submit waits for queue space.
        window: sliding-window length in segments (see :meth:`rotate_window`);
            ``None`` disables windowing.
        capacity: initial tenant capacity (rounded up to a power of two; grows by
            doubling as keys arrive — each growth captures the bucket graphs anew).
        telemetry_window: latency samples kept for the exact p50/p99.
        checkpoint: a :class:`CheckpointConfig` turns on the durable state plane:
            periodic snapshots, the WAL and, with ``resume=True`` (its default),
            recovery from what the directory holds when the engine starts.
        guard, replication, tier: the JAX package's other planes; not ported yet —
            anything but ``None`` raises ``NotImplementedError`` (ROADMAP A.7).
        device: where the engine serves; ``None`` serves on the metric's device (a
            metric's default device is the GPU). Otherwise the engine's clone of
            the metric moves there.
        telemetry_labels: extra labels on every telemetry series of this engine.
        start: launch the dispatcher thread immediately.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MulticlassAccuracy
        >>> from metrics_tpu_torch.engine import StreamingEngine
        >>> engine = StreamingEngine(MulticlassAccuracy(3, average="micro", device="cpu"), buckets=(4, 8))
        >>> for preds, target in [([1, 0], [1, 1]), ([2], [2])]:
        ...     fut = engine.submit("tenant-a", torch.tensor(preds), torch.tensor(target))
        >>> engine.flush()
        >>> engine.compute("tenant-a")
        tensor(0.6667)
        >>> engine.close()
    """

    def __init__(
        self,
        metric_or_collection: Any,
        *,
        buckets: Union[Sequence[int], BucketConfig] = DEFAULT_BUCKETS,
        max_queue: int = 1024,
        policy: str = "block",
        submit_timeout: float = 1.0,
        window: Optional[int] = None,
        capacity: int = 8,
        telemetry_window: int = 2048,
        checkpoint: Optional[CheckpointConfig] = None,
        guard: Optional[Any] = None,
        replication: Optional[Any] = None,
        tier: Optional[Any] = None,
        device: Optional[Any] = None,
        telemetry_labels: Optional[Dict[str, str]] = None,
        start: bool = True,
    ) -> None:
        if not isinstance(metric_or_collection, (Metric, MetricCollection)):
            raise MetricsTPUUserError(
                f"StreamingEngine serves a Metric or MetricCollection, got {type(metric_or_collection)!r}"
            )
        planes = {"guard": guard, "replication": replication, "tier": tier}
        for name, item in _PLANES:
            if planes[name] is not None:
                raise NotImplementedError(
                    f"StreamingEngine({name}=...) needs the {name} plane, which is not ported yet (ROADMAP {item})"
                )
        if policy not in _POLICIES:
            raise MetricsTPUUserError(f"`policy` must be one of {_POLICIES}, got {policy!r}")
        if max_queue < 1:
            raise MetricsTPUUserError(f"`max_queue` must be >= 1, got {max_queue}")

        self._metric = metric_or_collection.clone()
        if device is not None:
            self._metric.to_device(resolve_device(device))
        self._device = _component_metrics(self._metric)[0].device
        # reads get their OWN clone: compute_from swaps state attrs in and out of
        # its instance, so computing on the dispatch metric would race dispatch
        self._read_metric = self._metric.clone()
        self._read_lock = threading.Lock()
        self._buckets = normalize_buckets(buckets)
        self._max_rows = self._buckets[-1]
        self._max_queue = int(max_queue)
        self._policy = policy
        self._submit_timeout = float(submit_timeout)
        self.telemetry = EngineTelemetry(latency_window=telemetry_window, labels=telemetry_labels)

        # Fused eligibility is structural: every component metric must hold only
        # fixed-shape tensor states (ragged "cat" lists cannot stack along a key axis)
        # and compute on the device. Updates that cannot be captured are only
        # discoverable at the first capture — those demote then (`fused_fallbacks`).
        self._fused = all(
            not m._host_compute and not any(isinstance(d, list) for d in m._defaults.values())
            for m in _component_metrics(self._metric)
        )
        self._keyed: Union[KeyedState, EagerKeyedState] = (
            KeyedState(self._metric, capacity=capacity, window=window)
            if self._fused
            else EagerKeyedState(self._metric, window=window)
        )
        self._window = window

        # the dispatcher's stream and the graph memory pool all its graphs share
        # (a graph's temporaries are dead once its replay ends, and replays run one
        # at a time on this stream)
        self._stream: Optional[torch.cuda.Stream] = None
        self._graph_pool: Any = None
        if self._device.type == "cuda":
            self._stream = torch.cuda.Stream(self._device)
            self._graph_pool = torch.cuda.graph_pool_handle()
        # (signature, bucket, capacity) -> micro-batch kernel
        self._kernels: Dict[Tuple[Signature, int, int], Callable] = {}

        self._lock = threading.RLock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._queue: List[_Request] = []
        self._inflight = 0
        self._closed = False
        self._degraded = False
        # set by the guard plane's hang watchdog (ROADMAP A.7); health() reports it
        self._quarantined = False
        self._worker_error: Optional[BaseException] = None
        self._active_batch: Optional[List[_Request]] = None
        self._zombie_workers = 0
        # serializes use of the private metric instance and of the slab
        self._dispatch_lock = threading.Lock()
        # test/ops hook: clearing holds the dispatcher *before* it processes a drained
        # batch, letting backpressure be exercised deterministically
        self._worker_gate = threading.Event()
        self._worker_gate.set()

        # durable state plane (None-checked on every hot path: checkpointing off
        # costs one attribute test per drained batch)
        self._ckpt_cfg: Optional[CheckpointConfig] = None
        self._ckpt_store: Optional[SnapshotStore] = None
        self._ckpt_writer: Optional[AsyncCheckpointer] = None
        self._journal: Optional[RequestJournal] = None
        self._wal_seq = -1
        self._wal_error: Optional[BaseException] = None
        self._wal_key_cache: Dict[Hashable, bytes] = {}
        self._wal_slots_sent: set = set()  # slot ids already introduced to the journal
        self._replay_slot_keys: Dict[int, Hashable] = {}
        self._snapshot_seqs: Dict[int, int] = {}  # generation -> WAL seq it covers
        if checkpoint is not None:
            self._init_checkpoint(checkpoint)

        self._worker: Optional[threading.Thread] = None
        if start:
            self.start()

    # ------------------------------------------------------------------ lifecycle

    def start(self) -> None:
        with self._lock:
            if self._worker is not None or self._closed:
                return
            self._worker = threading.Thread(
                target=self._run, name="metrics-tpu-torch-engine-dispatch", daemon=True
            )
            self._worker.start()

    def close(self, flush: bool = True, checkpoint: bool = True) -> None:
        """Stop accepting work; by default drain what was already accepted.

        With checkpointing configured, a final snapshot is committed after the
        drain (``checkpoint=False`` skips it — the crash-simulation hook: the WAL
        then carries everything since the last periodic snapshot, exactly what a
        restart must replay).
        """
        with self._lock:
            if self._closed:
                return
        if flush:
            self.flush()
        if flush and checkpoint and self._ckpt_writer is not None:
            self._ckpt_writer.checkpoint_sync(self._checkpoint_view)
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()
            self._idle.notify_all()
            worker = self._worker
        if worker is not None and worker is not threading.current_thread():
            worker.join(timeout=10.0)
            if worker.is_alive():
                # the dispatcher outlived its join: surface the zombie instead of
                # returning as if the engine closed cleanly
                self._zombie_workers += 1
                self.telemetry.count("zombie_workers")
                warnings.warn(
                    "StreamingEngine.close(): dispatcher thread did not exit within "
                    "10s and is now a zombie (possibly wedged in a device call); "
                    "engine health is DEGRADED, state may be incomplete",
                    RuntimeWarning,
                    stacklevel=2,
                )
        if self._ckpt_writer is not None:
            self._ckpt_writer.close()
        if self._journal is not None:
            self._journal.close()

    def __enter__(self) -> "StreamingEngine":
        return self

    def __exit__(self, *exc_info: Any) -> None:
        self.close()

    @contextmanager
    def _on_stream(self) -> Iterator[None]:
        """The engine's device and stream as current (nothing on the CPU)."""
        if self._stream is None:
            yield
            return
        with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
            yield

    def _sync(self) -> None:
        if self._stream is not None:
            self._stream.synchronize()

    # ------------------------------------------------------------------ client API

    def submit(self, key: Hashable, *args: Any) -> "Future":
        """Enqueue one update for tenant ``key``; resolves to a receipt dict
        (``key``, ``rows``, ``bucket``) once the state update has committed.

        Raises :class:`EngineBackpressure` per the configured policy when the queue is
        full, and :class:`EngineClosed` after :meth:`close`.
        """
        t_submit = time.perf_counter()
        rows, signature = inspect_request(args)
        future: Future = Future()
        with self._not_full:
            if self._closed:
                raise EngineClosed("submit() on a closed StreamingEngine")
            if self._degraded or self._worker is None:
                # synchronous per-call dispatch (dispatcher dead or never started)
                req = _Request(key, self._alloc_slot(key), tuple(args), rows, signature, future, t_submit)
                self.telemetry.count("submitted")
                self._apply_inline(req)
                return future
            wait_deadline = time.monotonic() + self._submit_timeout
            while len(self._queue) >= self._max_queue:
                if self._policy == "drop":
                    self.telemetry.count("dropped")
                    raise EngineBackpressure(f"queue full ({self._max_queue}); request dropped")
                if self._policy == "timeout":
                    remaining = wait_deadline - time.monotonic()
                    if remaining <= 0:
                        self.telemetry.count("timed_out")
                        raise EngineBackpressure(
                            f"queue full ({self._max_queue}); timed out after {self._submit_timeout}s"
                        )
                    self._not_full.wait(remaining)
                else:
                    self._not_full.wait()
                if self._closed:
                    raise EngineClosed("StreamingEngine closed while waiting for queue space")
                if self._degraded:
                    req = _Request(key, self._alloc_slot(key), tuple(args), rows, signature, future, t_submit)
                    self.telemetry.count("submitted")
                    self._apply_inline(req)
                    return future
            req = _Request(key, self._alloc_slot(key), tuple(args), rows, signature, future, t_submit)
            self._queue.append(req)
            self.telemetry.count("submitted")
            self.telemetry.gauge_queue_depth(len(self._queue))
            self._not_empty.notify()
        return future

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until every accepted request has committed (or ``timeout`` elapses).

        Holds through a worker death too: the death handler keeps ``_inflight`` equal
        to the number of accepted-but-unreplayed requests while it replays them
        inline, so 'accepted implies committed after flush' survives degradation.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._idle:
            while self._queue or self._inflight:
                if deadline is None:
                    self._idle.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError("StreamingEngine.flush timed out")
                    self._idle.wait(remaining)

    def drain_tenant(self, key: Hashable, timeout: Optional[float] = None) -> None:
        """Block until no accepted-but-uncommitted request references ``key``.

        Unlike :meth:`flush`, whose whole-engine barrier never clears while
        neighbouring tenants keep the engine busy, this waits out only the requests
        for ``key`` in the queue and the active batch (poll-waiting on ``_idle``,
        which fires only on a full drain).
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._idle:
            while True:
                pending = any(req.key == key for req in self._queue)
                if not pending and self._active_batch is not None:
                    pending = any(req.key == key for req in self._active_batch)
                if not pending and self._inflight and self._active_batch is None:
                    # worker-death replay: the pending list lives off-structure
                    # and may hold our key — wait it out
                    pending = True
                if not pending:
                    return
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f"drain_tenant({key!r}) timed out")
                self._idle.wait(0.05)

    def evict_tenant(self, key: Hashable) -> bool:
        """Forget ``key`` entirely: its state and its window history. Returns
        False for an unknown key.

        Waits out only this key's accepted requests (not the whole engine), then,
        under the dispatch lock, journals the retirement (``b"T"``) BEFORE the slot
        id returns to the free list — so WAL replay reproduces retire-then-reuse in
        commit order and a recovered engine never aliases the freed row onto
        whichever new tenant reused it — scrubs the tenant's rows to their initial
        values and frees the slot, where the next new tenant takes it. Works on
        untiered engines too. The slab is written in place, so the captured graphs
        stay valid. (The tier bookkeeping comes with the tier plane, ROADMAP A.7.)
        """
        self.drain_tenant(key)
        with self._dispatch_lock, self._on_stream():
            if not self._is_resident(key):
                return False
            keyed = self._keyed
            if self._journal is not None:
                slot = keyed._slots.get(key, 0) if isinstance(keyed, KeyedState) else 0
                self._journal_append([_encode_tier_record(b"T", int(slot), self._key_bytes(key))])
            slot = keyed.evict(key)
            keyed.release_slot(slot)
            if slot is not None:
                self._wal_slots_sent.discard(slot)
            self._sync()
        self.telemetry.count("tier_evictions")
        return True

    def export_tenant(self, key: Hashable, *, retire: bool = True) -> Optional[Dict[str, Any]]:
        """Capture one tenant's full entry for a move to another engine; waits for the tier plane."""
        raise NotImplementedError("export_tenant() captures a residency entry through the tier plane, "
                                  "which is not ported yet (ROADMAP A.7)")

    def import_tenant(self, key: Hashable, entry: Optional[Dict[str, Any]]) -> None:
        """Install a tenant exported by another engine; waits for the tier plane."""
        raise NotImplementedError("import_tenant() installs a residency entry through the tier plane, "
                                  "which is not ported yet (ROADMAP A.7)")

    def _read_states(self, keys: Optional[Sequence[Hashable]], window: bool) -> Dict[Hashable, Any]:
        """Copies of the tenants' states, taken under the dispatch lock on the
        caller's stream. That stream first waits for the engine's stream and is
        synchronised before the lock is released, so no later replay can overwrite
        the slab under a copy still in flight."""
        with self._dispatch_lock:
            keyed = self._keyed
            if keys is None:
                keys = keyed.keys
            for key in keys:
                if not self._is_resident(key):
                    raise KeyError(f"unknown tenant key {key!r}")
            if self._stream is None:
                return {key: keyed.merged_state(key) if window else keyed.state_of(key) for key in keys}
            with torch.cuda.device(self._device):
                current = torch.cuda.current_stream()
                current.wait_stream(self._stream)
                states = {key: keyed.merged_state(key) if window else keyed.state_of(key) for key in keys}
                current.synchronize()
            return states

    def _check_read(self, op: str, window: bool, sync: bool) -> None:
        if window and self._window is None:
            # a silent fall-through would return unbounded lifetime accumulation
            # mislabeled as a sliding-window value
            raise MetricsTPUUserError(f"{op}(window=True) requires the engine to be built with `window=`")
        if sync:
            raise NotImplementedError(
                f"{op}(sync=True) all-reduces the state across processes through the comm plane, "
                "which is not ported yet (ROADMAP A.8)"
            )

    def compute(self, key: Hashable, *, window: bool = False, sync: bool = False) -> Any:
        """Final metric value for tenant ``key`` (flushes first).

        ``window=True`` computes over the sliding window (requires ``window=`` at
        construction). ``sync=True`` (the cross-process all-reduce) waits for the
        comm plane (ROADMAP A.8) and raises.
        """
        self._check_read("compute", window, sync)
        self.flush()
        state = self._read_states([key], window)[key]
        with self._read_lock:
            return self._read_metric.compute_from(state)

    def compute_all(self, *, window: bool = False, sync: bool = False) -> Dict[Hashable, Any]:
        """``compute`` for every known tenant key — one flush, one consistent snapshot
        (every state is copied under one dispatch-lock acquisition)."""
        self._check_read("compute_all", window, sync)
        self.flush()
        states = self._read_states(None, window)
        with self._read_lock:
            return {key: self._read_metric.compute_from(state) for key, state in states.items()}

    def rollup(self, *, window: bool = False) -> Any:
        """The global-query fold of every tenant; waits for the query plane."""
        raise NotImplementedError("rollup() serves the query plane, which is not ported yet (ROADMAP A.9)")

    def wal_watermark(self) -> Tuple[int, int]:
        """``(epoch, seq)`` — this engine's WAL position: the last journaled seq
        (``-1`` with no journaled write yet, or no durable plane at all). The epoch
        is 0: lineage epochs come with replication (ROADMAP A.7)."""
        if self._closed:
            raise EngineClosed("wal_watermark() on a closed StreamingEngine")
        return 0, int(self._wal_seq)

    def rotate_window(self) -> None:
        """Close the current sliding-window segment for ALL tenants (flushes first)."""
        self.flush()
        with self._dispatch_lock, self._on_stream():
            # journaled INSIDE the lock, before the transition: a recovery replays
            # it at exactly this point in the request order
            if self._journal is not None:
                self._journal_append([b"W"])
            self._keyed.rotate()
            self._sync()
        self.telemetry.count("window_rotations")

    def reset(self) -> None:
        """Drop all tenant state (keys stay allocated). The slab is written in
        place, so captured graphs stay valid."""
        self.flush()
        with self._dispatch_lock, self._on_stream():
            if self._journal is not None:
                self._journal_append([b"Z"])
            self._keyed.reset()
            self._sync()

    @property
    def fused(self) -> bool:
        """True while the engine serves through the micro-batch kernels."""
        return self._fused

    @property
    def degraded(self) -> bool:
        """True once the dispatcher died and submits run inline."""
        return self._degraded

    @property
    def device(self) -> torch.device:
        return self._device

    def health(self) -> Dict[str, Any]:
        """The engine's health state machine, one plain dict, with the JAX
        package's keys for an engine without planes.

        ``state`` walks ``SERVING → DEGRADED → QUARANTINED``: ``DEGRADED`` once the
        dispatcher died and submits run inline, the WAL was disabled after an IO
        failure (serving continues without it), or a zombie worker survived
        ``close()``; ``QUARANTINED`` once a hung dispatcher could not be
        superseded (the guard plane's watchdog, ROADMAP A.7). Without the guard
        plane there are no breakers, no shedding and no quarantined tenants.
        """
        with self._lock:
            quarantined = self._quarantined
            degraded = self._degraded
            zombies = self._zombie_workers
            worker = self._worker
            closed = self._closed
            queue_depth = len(self._queue)
        wal_disabled = self._wal_error is not None
        if quarantined:
            state = "QUARANTINED"
        elif degraded or zombies or wal_disabled:
            state = "DEGRADED"
        else:
            state = "SERVING"
        return {
            "state": state,
            "closed": closed,
            "worker_alive": worker is not None and worker.is_alive() and not degraded,
            "worker_restarts": 0,
            "zombie_workers": zombies,
            "queue_depth": queue_depth,
            "shedding": False,
            "wal_disabled": wal_disabled,
            "breakers": {},
            "quarantined_tenants": {},
        }

    def telemetry_snapshot(self) -> Dict[str, Any]:
        snap = self.telemetry.snapshot()
        snap["fused"] = self._fused
        snap["degraded"] = self._degraded
        snap["quarantined"] = self._quarantined
        snap["tenants"] = len(self._keyed.keys)
        if isinstance(self._keyed, KeyedState):
            snap["slab_bytes"] = sum(leaf.numel() * leaf.element_size() for leaf in self._slab_leaves())
        if self._ckpt_writer is not None:
            snap["ckpt_generation"] = self._ckpt_writer.last_generation
            snap["wal_seq"] = self._wal_seq
        return snap

    def graph_stats(self) -> List[Dict[str, Any]]:
        """One record per captured micro-batch graph: its cache key, warm-up and
        capture wall time, the pool growth during the capture, the launches the
        capture recorded by kernel name, and its replays."""
        with self._dispatch_lock:
            items = list(self._kernels.items())
        return [
            {
                "signature": sig, "bucket": bucket, "capacity": cap,
                "warmup_ms": k.warmup_ms, "capture_ms": k.capture_ms, "pool_bytes": k.pool_bytes,
                "captured_launches": dict(k.captured), "replays": k.replays,
            }
            for (sig, bucket, cap), k in items
            if isinstance(k, _GraphKernel) and k.graph is not None
        ]

    def graph_launches(self) -> Dict[str, int]:
        """Hand-kernel launches made by graph replays, by kernel name:
        launches captured × replays, summed over the graphs."""
        out: Dict[str, int] = {}
        for rec in self.graph_stats():
            for name, n in rec["captured_launches"].items():
                out[name] = out.get(name, 0) + n * rec["replays"]
        return out

    # ------------------------------------------------------------------ internals

    def _slab_leaves(self) -> List[torch.Tensor]:
        keyed = self._keyed
        trees = [keyed.stacked] + [snap for _, snap in (keyed._ring or [])]
        return [leaf for tree in trees for leaf in tree_flatten(tree)[0]]

    def _alloc_slot(self, key: Hashable) -> Optional[int]:
        return self._keyed.slot_for(key)

    def _is_resident(self, key: Hashable) -> bool:
        """O(1) tenant membership (``keyed.keys`` materialises a tuple)."""
        keyed = self._keyed
        table = keyed._slots if isinstance(keyed, KeyedState) else keyed._states
        return key in table

    def _run(self) -> None:
        while True:
            with self._not_empty:
                while not self._queue and not self._closed:
                    self._not_empty.wait(0.1)
                if not self._queue and self._closed:
                    return
                batch, self._queue = self._queue, []
                self._inflight = len(batch)
                self._active_batch = batch
                self.telemetry.gauge_queue_depth(0)
                self._not_full.notify_all()
            self._worker_gate.wait()
            try:
                self._process(batch)
                with self._lock:
                    self._active_batch = None
                    self._inflight = 0
                    self._idle.notify_all()
                self._maybe_checkpoint()
            except BaseException as exc:  # noqa: BLE001 — dispatcher death: degrade, don't lose work
                self._on_worker_death(exc, batch)
                return

    def _process(self, batch: List[_Request]) -> None:
        if self._fused:
            try:
                self._process_fused(batch)
                return
            except _FusedUnsupported:
                pass
            # A kernel failure is ambiguous: the metric's update may not be capturable
            # (demote permanently), or ONE malformed request may have poisoned its
            # chunk (reject that request, keep the fused path for everyone else). The
            # eager retry distinguishes them: it re-runs the same updates outside any
            # capture, so a malformed request fails ITS future there while an
            # uncapturable-but-valid update succeeds for every request.
            remaining = [req for req in batch if not req.future.done()]
            self._process_eager(remaining)
            if remaining and all(req.future.exception() is None for req in remaining):
                self._demote_to_eager()
            return
        self._process_eager([req for req in batch if not req.future.done()])

    # ---------------------------------------------------- fused (bucketed) dispatch

    def _process_fused(self, batch: List[_Request]) -> None:
        with self._dispatch_lock, self._on_stream():
            if self._keyed.ensure_capacity():
                self.telemetry.count("key_growths")
                self.telemetry.observe_resize(self._keyed.last_resize_s)
                self._drop_stale_graphs()
            for signature, reqs in self._signature_groups(batch):
                self._dispatch_group(signature, reqs)

    @staticmethod
    def _signature_groups(batch: List[_Request]) -> List[Tuple[Signature, List[_Request]]]:
        """Coalesce the drained batch into dispatch groups of one shape signature.

        Batch-wide grouping maximizes bucket occupancy but replays a tenant's
        requests signature-by-signature, which reorders them when ONE tenant mixes
        shapes in the same drain. Per-tenant submission order is part of the engine's
        sequential-semantics contract, so that (rare) case falls back to grouping by
        consecutive same-signature runs — order-preserving, slightly smaller
        micro-batches."""
        tenant_sig: Dict[Hashable, Signature] = {}
        mixed = False
        for req in batch:
            prev = tenant_sig.setdefault(req.key, req.signature)
            if prev != req.signature:
                mixed = True
                break
        groups: List[Tuple[Signature, List[_Request]]] = []
        if not mixed:
            by_sig: Dict[Signature, List[_Request]] = {}
            for req in batch:
                by_sig.setdefault(req.signature, []).append(req)
            groups.extend(by_sig.items())
        else:
            for req in batch:
                if groups and groups[-1][0] == req.signature:
                    groups[-1][1].append(req)
                else:
                    groups.append((req.signature, [req]))
        return groups

    def _dispatch_group(self, signature: Signature, reqs: List[_Request]) -> None:
        # expand oversized requests into row-chunks, then greedily pack chunks into
        # micro-batches of at most max_rows rows
        units: List[Tuple[_Request, Tuple[Any, ...], int, bool]] = []
        for req in reqs:
            chunks = split_rows(req.args, self._max_rows)
            for i, (chunk_args, rows) in enumerate(chunks):
                units.append((req, chunk_args, rows, i == len(chunks) - 1))

        pending: List[Tuple[_Request, Tuple[Any, ...], int, bool]] = []
        pending_rows = 0
        for unit in units:
            if pending and pending_rows + unit[2] > self._max_rows:
                self._dispatch_chunk(signature, pending, pending_rows)
                pending, pending_rows = [], 0
            pending.append(unit)
            pending_rows += unit[2]
        if pending:
            self._dispatch_chunk(signature, pending, pending_rows)

    def _dispatch_chunk(
        self,
        signature: Signature,
        units: List[Tuple[_Request, Tuple[Any, ...], int, bool]],
        total_rows: int,
    ) -> None:
        bucket = choose_bucket(total_rows, self._buckets)
        kernel = self._get_kernel(signature, bucket, self._keyed.capacity)
        columns, key_ids, mask, host = pad_micro_batch(
            [(req.slot, chunk_args, rows) for req, chunk_args, rows, _ in units], bucket, self._device
        )
        kernel(self._keyed, key_ids, mask, columns)
        # commit before completing futures: surfaces device-side errors here and makes
        # the receipt mean "your rows are in the state", not "your rows are enqueued"
        self._sync()
        # WAL after commit, before acks, from the host arrays (no read of the card):
        # an acknowledged chunk is always replayable, and a chunk whose capture
        # failed is never journaled (its eager retry journals per request)
        if self._journal is not None:
            self._journal_chunk(units, *host)
        self.telemetry.observe_batch(total_rows, bucket)
        now = time.perf_counter()
        for req, _, rows, is_last in units:
            req.rows_done += rows
            if not is_last:
                continue
            self.telemetry.count("processed")
            self.telemetry.observe_latency(now - req.t_submit)
            req.future.set_result({"key": req.key, "rows": req.rows, "bucket": bucket})

    def _get_kernel(self, signature: Signature, bucket: int, capacity: int) -> Callable:
        cache_key = (signature, bucket, capacity)
        kernel = self._kernels.get(cache_key)
        if kernel is None:
            # one cache miss == one capture (the JAX package: one trace)
            self.telemetry.count("compiles")
            kernel = self._build_kernel()
            self._kernels[cache_key] = kernel
        return kernel

    def _drop_stale_graphs(self) -> None:
        """Graphs captured on an older slab are keyed by its capacity and can never
        replay again: free them (and their static buffers)."""
        self._kernels = {k: v for k, v in self._kernels.items() if k[2] == self._keyed.capacity}

    def _build_kernel(self) -> Callable:
        """One micro-batch kernel: the masked per-row scan over the stacked slab
        (:mod:`metrics_tpu_torch.kernels.engine_scan`), captured as a CUDA graph on
        the card and run as a loop on the CPU."""
        if self._stream is None:
            return _LoopKernel(self._metric.update_state)
        return _GraphKernel(self._metric.update_state, self._stream, self._graph_pool)

    def _demote_to_eager(self) -> None:
        """Permanent fused→eager fallback: migrate accumulated stacked state."""
        with self._dispatch_lock, self._on_stream():
            old = self._keyed
            eager = EagerKeyedState(self._metric, window=self._window)
            for key in old.keys:
                eager.slot_for(key)
                eager.set_state(key, old.state_of(key))
            if old._ring is not None and eager._ring is not None:
                for cap, snap in old._ring:
                    seg: Dict[Hashable, Any] = {}
                    for key in old.keys:
                        slot = old._slots[key]
                        if slot < cap:
                            seg[key] = tree_map(lambda x, s=slot: x[s].clone(), snap)
                    eager._ring.append(seg)
            eager.rotations = old.rotations
            self._sync()
            self._keyed = eager
            self._fused = False
            self._kernels.clear()
        self.telemetry.count("fused_fallbacks")

    # ---------------------------------------------------- eager / degraded dispatch

    def _process_eager(self, batch: List[_Request]) -> None:
        for req in batch:
            self._apply_inline(req)

    def _apply_inline(self, req: _Request) -> None:
        """Synchronous per-request dispatch (eager mode, and the degraded path).

        Applies only the rows a fused chunk has not already committed, so a request
        caught mid-demotion is never double-counted; the skip check and the
        applied marker both sit under the dispatch lock, so two appliers serialize.
        """
        try:
            args = req.args if req.rows_done == 0 else tuple(a[req.rows_done :] for a in req.args)
            with self._dispatch_lock, self._on_stream():
                if req.future.done() or (req.rows > 0 and req.rows_done >= req.rows):
                    return
                # journal INSIDE the dispatch lock: a snapshot (same lock) must never
                # record WAL coverage of a not-yet-applied request. Trimmed args keep
                # rows already committed (and chunk-journaled) out of the record
                self._journal_requests([req], args_override=args)
                args = tuple(as_request_tensor(a, self._device) for a in args)
                if isinstance(self._keyed, EagerKeyedState):
                    self._keyed.update(req.key, *args)
                else:
                    state = self._keyed.state_of(req.key)
                    self._keyed.set_state(req.key, self._metric.update_state(state, *args))
                self._sync()
                req.rows_done = req.rows
        except Exception as exc:  # noqa: BLE001 — fail THIS request, keep serving
            try:
                req.future.set_exception(exc)
            except Exception:  # noqa: BLE001 — already resolved by a racing applier
                return
            self.telemetry.count("failed")
            return
        try:
            req.future.set_result({"key": req.key, "rows": req.rows, "bucket": None})
        except Exception:  # noqa: BLE001 — already resolved by a racing applier
            return
        self.telemetry.count("processed")
        if self._degraded or self._worker is None:
            # only true caller-thread dispatch counts: the healthy eager path also
            # lands here, and counting it would make a healthy engine look degraded
            self.telemetry.count("inline_dispatches")
        self.telemetry.observe_latency(time.perf_counter() - req.t_submit)

    def _on_worker_death(self, exc: BaseException, batch: List[_Request]) -> None:
        """Dispatcher crashed: complete all accepted work inline, then degrade.

        ``_inflight`` stays equal to the unreplayed remainder throughout, so a
        concurrent ``flush()`` keeps blocking until the replay finishes — 'accepted
        implies committed after flush' holds across the degradation. (The JAX
        package's guard plane can restart a dispatcher afterwards; that waits for
        ROADMAP A.7.)
        """
        self._worker_error = exc
        self.telemetry.count("worker_deaths")
        with self._lock:
            self._degraded = True
            self._active_batch = None
            pending = [req for req in batch if not req.future.done()] + self._queue
            self._queue = []
            self._inflight = len(pending)
            self.telemetry.gauge_queue_depth(0)
            self._not_full.notify_all()
        try:
            for req in pending:
                self._apply_inline(req)
                with self._lock:
                    self._inflight -= 1
        finally:
            with self._lock:
                self._inflight = 0
                self._idle.notify_all()


    # ---------------------------------------------------- durable state plane

    def _init_checkpoint(self, cfg: CheckpointConfig) -> None:
        if cfg.wal_flush not in _WAL_FLUSH:
            raise MetricsTPUUserError(f"`wal_flush` must be one of {_WAL_FLUSH}, got {cfg.wal_flush!r}")
        if cfg.wal_fsync not in _WAL_FSYNC:
            raise MetricsTPUUserError(f"`wal_fsync` must be one of {_WAL_FSYNC}, got {cfg.wal_fsync!r}")
        if cfg.wal_fsync == "interval" and cfg.wal_fsync_interval_s <= 0:
            raise MetricsTPUUserError(
                f"`wal_fsync_interval_s` must be > 0 in interval mode, got {cfg.wal_fsync_interval_s!r}"
            )
        self._wal_last_fsync = time.monotonic()
        self._ckpt_cfg = cfg
        self._ckpt_store = SnapshotStore(
            cfg.directory, retain=cfg.retain, rank=cfg.rank, world=cfg.world, durable=cfg.durable
        )
        if cfg.wal:
            self._journal = RequestJournal(cfg.directory, rank=cfg.rank, durable=cfg.durable)
        self._ckpt_writer = AsyncCheckpointer(
            self._ckpt_store,
            interval_s=cfg.interval_s,
            site="engine",
            policy=cfg.policy,
            schema_version=_ENGINE_SCHEMA_VERSION,
            on_commit=self._on_snapshot_commit,
            on_error=self._on_snapshot_error,
        )
        if cfg.resume:
            try:
                self._recover()
            except BaseException:
                # the constructor fails: stop the writer thread and release the WAL
                self._ckpt_writer.close()
                if self._journal is not None:
                    self._journal.close()
                raise

    def _on_snapshot_commit(self, generation: int, tree: Any, meta: Optional[Dict[str, Any]]) -> None:
        """Writer-thread callback: rotate the WAL past what every RETAINED
        generation covers. Rotating to the newest snapshot's seq would be wrong:
        if that file is later corrupted, recovery falls back to an older
        generation whose tail records must still be replayable — so the rotation
        point is the OLDEST retained generation's coverage."""
        self.telemetry.count("checkpoints")
        journal = self._journal
        if journal is None:
            return
        self._snapshot_seqs[generation] = int(tree["seq"])
        retained = self._ckpt_store.generations()
        self._snapshot_seqs = {g: s for g, s in self._snapshot_seqs.items() if g in retained}
        covered = None
        for gen in retained:
            seq = self._snapshot_seqs.get(gen)
            if seq is None:
                try:  # generation committed by a previous process: read its meta
                    seq = int(self._ckpt_store.read_meta(gen).get("seq", -1))
                    self._snapshot_seqs[gen] = seq
                except Exception:  # noqa: BLE001 — unreadable: don't rotate past it
                    seq = -1
            covered = seq if covered is None else min(covered, seq)
        if covered is not None and covered >= 0:
            journal.rotate(covered_seq=covered)

    def _on_snapshot_error(self, exc: BaseException) -> None:
        """Writer-thread callback: count the absorbed failure."""
        self.telemetry.count("checkpoint_failures")

    def _key_bytes(self, key: Hashable) -> bytes:
        key_bytes = self._wal_key_cache.get(key)
        if key_bytes is None:
            key_bytes = self._wal_key_cache[key] = pickle.dumps(key, protocol=pickle.HIGHEST_PROTOCOL)
        return key_bytes

    def _journal_append(self, payloads: List[bytes]) -> Optional[List[int]]:
        """Append + flush per policy (caller holds the dispatch lock); a journal IO
        failure disables the WAL (counted, remembered, ``health()["wal_disabled"]``)
        instead of failing serving — durability degrades, availability does not."""
        try:
            seqs = self._journal.append_many(payloads)
            flush = self._ckpt_cfg.wal_flush
            fsync = flush == "fsync" or self._wal_fsync_due()
            if flush != "none" or fsync:
                self._journal.flush(fsync=fsync)
                if fsync:
                    self._wal_last_fsync = time.monotonic()
        except Exception as exc:  # noqa: BLE001
            self._wal_error = exc
            journal, self._journal = self._journal, None
            try:
                journal.close()  # release the fd; flush whatever still can be
            except Exception:  # noqa: BLE001 — already in the failure path
                pass
            self.telemetry.count("checkpoint_failures")
            return None
        self._wal_seq = max(self._wal_seq, seqs[-1])
        self.telemetry.count("wal_records", len(payloads))
        return seqs

    def _wal_fsync_due(self) -> bool:
        """Does the ``wal_fsync`` policy demand a sync on this append?"""
        policy = self._ckpt_cfg.wal_fsync
        if policy == "commit":
            return True
        if policy == "interval":
            return time.monotonic() - self._wal_last_fsync >= self._ckpt_cfg.wal_fsync_interval_s
        return False

    def _journal_chunk(
        self,
        units: List[Tuple[_Request, Tuple[Any, ...], int, bool]],
        columns: Sequence[np.ndarray],
        key_ids: np.ndarray,
        mask: np.ndarray,
    ) -> None:
        """Journal one committed fused micro-batch as a single chunk record, from
        the host arrays ``pad_micro_batch`` built it from.

        Called AFTER the replay was synchronised and BEFORE the chunk's futures
        resolve: an acknowledged request is always either in a snapshot or
        replayable, and a chunk that failed to capture is never journaled (its
        eager retry journals per request instead — no double entry).
        """
        new_slots = []
        for req, _, _, _ in units:
            if req.slot not in self._wal_slots_sent:
                self._wal_slots_sent.add(req.slot)
                new_slots.append((req.slot, self._key_bytes(req.key)))
        self._journal_append([_encode_chunk_record(new_slots, key_ids, mask, columns)])

    def _journal_requests(self, reqs: List[_Request], args_override: Optional[Tuple[Any, ...]] = None) -> None:
        """Per-request WAL records for the non-fused paths (eager metrics,
        degraded/inline submits, the eager retry). ``args_override`` journals a
        trimmed argument view when part of the request already committed (and was
        journaled) through fused chunks."""
        if self._journal is None:
            return
        todo = [req for req in reqs if req.seq is None]
        if not todo:
            return
        payloads = [
            _encode_request_record(self._key_bytes(req.key), req.args if args_override is None else args_override)
            for req in todo
        ]
        seqs = self._journal_append(payloads)
        if seqs is not None:
            for req, seq in zip(todo, seqs):
                req.seq = seq

    def _checkpoint_view(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Consistent host-side snapshot tree of ALL tenant state + WAL position.

        The slab is overwritten in place by every replay, so the copy to the host
        is taken under the dispatch lock, whose every holder synchronises the
        engine's stream before releasing it, and the writer thread gets numpy
        arrays only, never tensors. The tree is the JAX package's.
        """
        with self._dispatch_lock, self._on_stream():
            keyed = self._keyed
            tree: Dict[str, Any] = {"kind": "engine", "seq": int(self._wal_seq)}
            tree["rotations"] = int(keyed.rotations)
            if isinstance(keyed, KeyedState):
                tree["mode"] = "fused"
                tree["capacity"] = int(keyed.capacity)
                tree["slots"] = dict(keyed._slots)  # non-str keys -> object leaf
                tree["stacked"] = host_tree(keyed.stacked)
                tree["ring"] = [
                    {"capacity": int(cap), "stacked": host_tree(snap)} for cap, snap in (keyed._ring or [])
                ]
            else:
                keys = list(keyed._states)
                tree["mode"] = "eager"
                tree["keys"] = {"values": keys}  # wrapped: keys may be non-JSON-able
                tree["states"] = [host_tree(keyed._states[k]) for k in keys]
                tree["ring"] = [
                    {"keys": {"values": list(seg)}, "states": [host_tree(seg[k]) for k in seg]}
                    for seg in (keyed._ring or [])
                ]
            self._sync()
        meta = {"tenants": len(keyed.keys), "seq": tree["seq"]}
        return tree, meta

    def _maybe_checkpoint(self) -> None:
        if self._ckpt_writer is None:
            return
        try:
            self._ckpt_writer.maybe_checkpoint(self._checkpoint_view)
        except Exception:  # noqa: BLE001 — a snapshot failure must not kill the dispatcher
            self.telemetry.count("checkpoint_failures")

    def checkpoint_now(self) -> Optional[int]:
        """Flush, then snapshot synchronously; returns the committed generation.

        ``None`` when checkpointing is off or the write failed (the failure is
        counted and kept on ``self._ckpt_writer.last_error``, never raised).
        """
        if self._ckpt_writer is None or self._quarantined:
            return None
        self.flush()
        return self._ckpt_writer.checkpoint_sync(self._checkpoint_view)

    def _validate_engine_snapshot(self, snap: Any) -> None:
        """The recovery scan's check of one generation: raises ``ValueError`` (the
        generation is skipped) where it does not fit this engine's metric, and
        ``NotImplementedError`` for a tiered engine's snapshot (ROADMAP A.7)."""
        tree = snap.tree
        if snap.schema_version != _ENGINE_SCHEMA_VERSION:
            raise ValueError(f"engine snapshot schema v{snap.schema_version} != v{_ENGINE_SCHEMA_VERSION}")
        if not isinstance(tree, dict) or tree.get("kind") != "engine":
            raise ValueError("not an engine snapshot")
        if tree.get("tier"):
            raise NotImplementedError(
                "this engine snapshot holds tenants out of the device slab (a tiered engine's); restoring it "
                "needs the tier plane, which is not ported yet (ROADMAP A.7)"
            )
        mode = tree.get("mode")
        ref = self._metric.init_state()
        ref_leaves = tree_flatten(ref)[0]
        if mode == "fused":
            if not isinstance(self._keyed, KeyedState):
                raise ValueError("fused snapshot but the live engine serves eagerly")
            cap = int(tree["capacity"])
            for entry in [tree] + list(tree.get("ring", [])):
                ecap = int(entry["capacity"]) if "capacity" in entry else cap
                for want, got in zip(ref_leaves, _leaves_like(entry["stacked"], ref)):
                    if dtype_name(got) != dtype_name(want) or tuple(got.shape) != (ecap, *want.shape):
                        raise ValueError(
                            f"stacked leaf {dtype_name(got)}{tuple(got.shape)} does not match "
                            f"live {dtype_name(want)}{(ecap, *want.shape)}"
                        )
        elif mode == "eager":
            for entry in [tree] + list(tree.get("ring", [])):
                if len(entry["keys"]["values"]) != len(entry["states"]):
                    raise ValueError("eager snapshot keys/states length mismatch")
                for st in entry["states"]:
                    # top-level key check only: ragged cat lists make a full
                    # structure comparison reject legitimate snapshots
                    if not isinstance(st, dict) or set(st) != set(ref):
                        raise ValueError("eager state structure does not match the live metric")
        else:
            raise ValueError(f"unknown engine snapshot mode {mode!r}")

    def _restore_keyed(self, tree: Dict[str, Any]) -> None:
        """Install a validated snapshot (caller holds the dispatch lock). A fused
        snapshot is copied into the live slab in place (grown to its capacity
        first), so no graph is left bound to freed memory; an eager one demotes a
        fused engine up front — recovering slower beats refusing to recover."""
        if tree["mode"] == "fused":
            ref = self._metric.init_state()
            self._keyed.restore(
                tree["capacity"],
                _leaves_like(tree["stacked"], ref),
                tree["slots"],
                [(entry["capacity"], _leaves_like(entry["stacked"], ref)) for entry in tree.get("ring", [])],
                tree.get("rotations", 0),
            )
            self._drop_stale_graphs()
            return
        if not isinstance(self._keyed, EagerKeyedState):
            self._fused = False
            self._kernels.clear()
        keyed = EagerKeyedState(self._metric, window=self._window)
        keyed._states = dict(zip(tree["keys"]["values"], _device_tree(tree["states"], self._device)))
        if keyed._ring is not None:
            for entry in tree.get("ring", []):
                keyed._ring.append(dict(zip(entry["keys"]["values"], _device_tree(entry["states"], self._device))))
        keyed.rotations = int(tree.get("rotations", 0))
        self._keyed = keyed

    @staticmethod
    def _chunk_signature(columns: Sequence[np.ndarray]) -> Signature:
        """The request signature a chunk record's columns were padded under: a
        column is (bucket, 1, *trailing), and the dtype is narrowed as submits are
        (``bucketing.narrow_name``), so a chunk journaled by either package maps
        to the graph key its live requests use."""
        return tuple((tuple(int(s) for s in col.shape[2:]), narrow_name(col.dtype.name)) for col in columns)

    def _replay_chunk(self, payload: bytes) -> None:
        """Re-apply one fused micro-batch record (caller holds the dispatch lock,
        on the engine's stream).

        A fused engine replays it through its OWN bucket graph — the record holds
        the padded columns + key ids + mask exactly as the journaling kernel saw
        them, so one replay reproduces the committed result bit for bit at full
        speed. Slot intros install the JOURNALING engine's ids (key_ids index by
        them; intros may arrive gapped because chunk commit order is not slot
        assignment order). A demoted/eager engine — or a chunk whose update cannot
        be captured here — falls back to the per-row walk, which is the same scan
        semantics, only slower.
        """
        off = 1
        (n_new,) = struct.unpack_from("<H", payload, off)
        off += 2
        for _ in range(n_new):
            (slot,) = _WAL_U32.unpack_from(payload, off)
            off += 4
            (klen,) = _WAL_U32.unpack_from(payload, off)
            off += 4
            key = pickle.loads(payload[off : off + klen])
            off += klen
            self._replay_slot_keys[slot] = key
            if isinstance(self._keyed, KeyedState):
                self._keyed.install_slot(key, slot)
        ncols = payload[off]
        off += 1
        key_ids, off = _dec_array(payload, off)
        mask, off = _dec_array(payload, off)
        columns = []
        for _ in range(ncols):
            col, off = _dec_array(payload, off)
            columns.append(col.astype(narrow_name(col.dtype.name), copy=False))
        keyed, dev = self._keyed, self._device
        if isinstance(keyed, KeyedState):
            max_id = int(key_ids.max()) + 1 if len(key_ids) else 0
            if keyed.ensure_capacity(min_slots=max_id):
                self.telemetry.count("key_growths")
                self.telemetry.observe_resize(keyed.last_resize_s)
                self._drop_stale_graphs()
            try:
                kernel = self._get_kernel(self._chunk_signature(columns), int(len(key_ids)), keyed.capacity)
                kernel(keyed, _as_state_tensor(key_ids, dev), _as_state_tensor(mask, dev),
                       [_as_state_tensor(c, dev) for c in columns])
                return
            except _FusedUnsupported:
                pass  # not capturable on this engine: per-row walk below
        for i in range(len(key_ids)):
            if not mask[i]:
                continue
            key = self._replay_slot_keys[int(key_ids[i])]
            rows = tuple(_as_state_tensor(col[i], dev) for col in columns)  # (1, *trailing): the scan slice
            if isinstance(keyed, KeyedState):
                keyed.set_state(key, self._metric.update_state(keyed.state_of(key), *rows))
            else:
                keyed.slot_for(key)
                keyed.update(key, *rows)

    def _replay_request(self, key: Hashable, args: Tuple[np.ndarray, ...]) -> None:
        """Re-apply one 'R' record as ONE whole-request update — exactly how the
        eager/inline paths that produce these records applied it, so float
        accumulation rounds as it did in the lost process."""
        args = tuple(as_request_tensor(a, self._device) for a in args)
        keyed = self._keyed
        keyed.slot_for(key)
        if isinstance(keyed, EagerKeyedState):
            keyed.update(key, *args)
        else:
            keyed.ensure_capacity()
            keyed.set_state(key, self._metric.update_state(keyed.state_of(key), *args))

    def _replay_retire(self, payload: bytes) -> None:
        """Replay one b"T" record: forget the tenant and free its slot."""
        _, key = _decode_tier_record(payload)
        if self._is_resident(key):
            slot = self._keyed.evict(key)
            self._keyed.release_slot(slot)
            if slot is not None:
                self._replay_slot_keys.pop(slot, None)
                self._wal_slots_sent.discard(slot)

    def _apply_wal_payload(self, payload: bytes) -> None:
        """Dispatch one WAL record to its replayer (caller holds the dispatch lock,
        on the engine's stream)."""
        kind = payload[:1]
        if kind == b"C":
            self._replay_chunk(payload)
        elif kind == b"R":
            self._replay_request(*_decode_request_record(payload))
        elif kind == b"Z":
            self._keyed.reset()
        elif kind == b"W":
            self._keyed.rotate()
        elif kind == b"T":
            self._replay_retire(payload)
        elif kind in (b"D", b"P"):
            raise NotImplementedError(
                f"WAL record {kind.decode()!r} ({'demote' if kind == b'D' else 'promote'}) comes from a tiered "
                "engine; replaying it needs the tier plane, which is not ported yet (ROADMAP A.7)"
            )
        else:
            raise ValueError(f"unknown WAL record kind {kind!r}")

    def _recover(self) -> None:
        """Restart path: newest valid snapshot + exactly-once WAL replay, on this
        engine's device. A record that failed when it was first accepted fails
        again and is counted (``failed``); a record of a plane that is not ported
        raises ``NotImplementedError`` out of the constructor instead of being
        skipped."""
        t0 = time.perf_counter()
        found = self._ckpt_store.latest_valid(validate=self._validate_engine_snapshot)
        with self._dispatch_lock, self._on_stream():
            if found is not None:
                gen, snap = found
                self._restore_keyed(snap.tree)
                self._wal_seq = int(snap.tree.get("seq", -1))
                if snap.tree["mode"] == "fused":
                    # chunk records reference slot ids; mappings introduced before
                    # the snapshot live in rotated-away segments, so seed the table
                    # from the snapshot's own slot map
                    self._replay_slot_keys = {slot: key for key, slot in snap.tree["slots"].items()}
                self.telemetry.count("recoveries")
                _obs.record_ckpt_io(
                    "engine", "restore", os.path.getsize(self._ckpt_store.path(gen)),
                    time.perf_counter() - t0, generation=gen,
                )
            if self._journal is not None:
                # a journal emptied by the rotation after a final snapshot numbers
                # on from the snapshot's seq, not from 0 (the JAX package restarts
                # at 0, and a second restart then replays none of the new records)
                self._journal.skip_to(self._wal_seq)
                replayed = 0
                for seq, payload in self._journal.replay(after_seq=self._wal_seq):
                    try:
                        self._apply_wal_payload(payload)
                    except NotImplementedError:
                        raise
                    except Exception:  # noqa: BLE001 — it failed when first accepted too
                        self.telemetry.count("failed")
                    replayed += 1
                    self._wal_seq = max(self._wal_seq, seq)
                if replayed:
                    self.telemetry.count("replayed", replayed)
            self._drop_stale_graphs()
            self._sync()
