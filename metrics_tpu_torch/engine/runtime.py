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

Not ported yet: the durable state plane (``checkpoint=``, ROADMAP A.6); the guard,
replication and tier planes (``guard=``, ``replication=``, ``tier=``, A.7), and with
them trace contexts, the flight recorder, dispatcher restarts, ``export_tenant`` and
``import_tenant``; ``compute(sync=True)``
(A.8); ``rollup`` (A.9). Each raises ``NotImplementedError`` naming its item. Reads
compute eagerly from a copy of the tenant's state (the JAX package's jitted read path
is not captured yet, so ``read_jit_fallbacks`` stays 0).
"""

from __future__ import annotations

import threading
import time
import warnings
from concurrent.futures import Future
from contextlib import contextmanager
from typing import Any, Callable, Dict, Hashable, Iterator, List, Optional, Sequence, Tuple, Union

import torch
from torch.utils._pytree import tree_flatten, tree_map

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.engine.bucketing import (
    DEFAULT_BUCKETS,
    BucketConfig,
    Signature,
    choose_bucket,
    as_request_tensor,
    inspect_request,
    normalize_buckets,
    pad_micro_batch,
    split_rows,
)
from metrics_tpu_torch.engine.stream import EagerKeyedState, KeyedState, _clone_tree
from metrics_tpu_torch.engine.telemetry import EngineTelemetry
from metrics_tpu_torch.kernels import launch_counts
from metrics_tpu_torch.kernels.engine_scan import masked_scan_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.checks import traced
from metrics_tpu_torch.utils.device import resolve_device
from metrics_tpu_torch.utils.graphs import capture
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

_POLICIES = ("block", "drop", "timeout")

# the planes that wait for a later slice, and their ROADMAP items
_PLANES = (("checkpoint", "A.6"), ("guard", "A.7"), ("replication", "A.7"), ("tier", "A.7"))


class EngineClosed(MetricsTPUUserError):
    """submit() after close()."""


class EngineBackpressure(MetricsTPUUserError):
    """Request rejected at a full queue (drop policy, or timeout policy expiry)."""


class _FusedUnsupported(Exception):
    """Internal: the metric's update cannot run inside the micro-batch kernel."""


class _Request:
    __slots__ = ("key", "slot", "args", "rows", "signature", "future", "t_submit", "rows_done")

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
        checkpoint, guard, replication, tier: the JAX package's planes; not ported
            yet — anything but ``None`` raises ``NotImplementedError``.
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
        checkpoint: Optional[Any] = None,
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
        planes = {"checkpoint": checkpoint, "guard": guard, "replication": replication, "tier": tier}
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

    def close(self, flush: bool = True) -> None:
        """Stop accepting work; by default drain what was already accepted."""
        with self._lock:
            if self._closed:
                return
        if flush:
            self.flush()
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
        under the dispatch lock, scrubs the tenant's rows to their initial values
        and returns its slot to the free list, where the next new tenant takes it.
        Works on untiered engines too. The slab is written in place, so the
        captured graphs stay valid. (The JAX package journals the retirement
        first; that record comes with the durable state plane, ROADMAP A.6, and
        the tier bookkeeping with the tier plane, A.7.)
        """
        self.drain_tenant(key)
        with self._dispatch_lock, self._on_stream():
            if not self._is_resident(key):
                return False
            keyed = self._keyed
            keyed.release_slot(keyed.evict(key))
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

    def rotate_window(self) -> None:
        """Close the current sliding-window segment for ALL tenants (flushes first)."""
        self.flush()
        with self._dispatch_lock, self._on_stream():
            self._keyed.rotate()
            self._sync()
        self.telemetry.count("window_rotations")

    def reset(self) -> None:
        """Drop all tenant state (keys stay allocated). The slab is written in
        place, so captured graphs stay valid."""
        self.flush()
        with self._dispatch_lock, self._on_stream():
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
        dispatcher died and submits run inline, or a zombie worker survived
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
        if quarantined:
            state = "QUARANTINED"
        elif degraded or zombies:
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
            "wal_disabled": False,
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
                # graphs captured on the old slab are keyed by the old capacity and
                # can never replay again: free them (and their static buffers)
                self._kernels = {k: v for k, v in self._kernels.items() if k[2] == self._keyed.capacity}
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
        columns, key_ids, mask = pad_micro_batch(
            [(req.slot, chunk_args, rows) for req, chunk_args, rows, _ in units], bucket, self._device
        )
        kernel(self._keyed, key_ids, mask, columns)
        # commit before completing futures: surfaces device-side errors here and makes
        # the receipt mean "your rows are in the state", not "your rows are enqueued"
        self._sync()
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

