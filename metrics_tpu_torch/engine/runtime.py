"""StreamingEngine — async micro-batched, multi-tenant metric serving
(port of ``metrics_tpu/engine/runtime.py`` with its durable, guard, tier and
replication planes).

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
   (``inline_dispatches``) — no request is ever silently lost. With a guard
   plane that allows restarts, a fresh dispatcher then takes over.

Backpressure at a full queue follows ``policy``: ``"block"`` (wait for space),
``"drop"`` (raise :class:`EngineBackpressure` immediately), ``"timeout"`` (wait up to
``submit_timeout`` seconds, then raise).

One CUDA stream per engine carries every host-to-device copy, replay and slab write,
whichever thread issues them, and every access to the slab happens under the
dispatch lock. The dispatcher synchronises that stream before it acknowledges a
batch; a reader's copies wait for the stream, and the stream waits for them, so
no reader races a replay, and a read holds the lock for its enqueue only.

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

Guard plane (``guard=GuardConfig(...)``, :mod:`metrics_tpu_torch.guard`): admission
(quotas, quarantined tenants, expired deadlines) on the caller's thread at
``submit``; a weighted fair drain, deadline expiry and CoDel shedding on the
dispatcher; breakers around graph captures (a refused novel signature runs
eagerly on the engine's own device, ``compile_rejections``) and checkpoint
commits; and a watchdog that supersedes a hung dispatcher. A CUDA graph replay
cannot be interrupted, so the watchdog probes the dispatch lock: free, the hang
was outside the device path and the taken-over requests are applied inline on
the engine's stream (then a fresh dispatcher starts); held, the engine
quarantines itself and fails every pending future fast. A superseded worker
checks its epoch under the dispatch lock and never replays.

Tier plane (``tier=TierConfig(...)``, :mod:`metrics_tpu_torch.tier`): the slab
holds at most ``hot_capacity`` tenants; the coldest are demoted between
micro-batches to host-RAM entries (a pass that demotes many copies their rows
off the card in one gather per leaf), the warm overflow spills to MTCKPT1 files,
and a submit to a non-resident tenant promotes it into a free slab row, in
place, before the replay that reads it. Freed rows are reused before the slab
grows, so past its doubling boundary a sweep over more tenants than the hot
set captures no new graph. Demotions, promotions and retirements are journaled
(``D``, ``P``, ``T``) and a snapshot carries the residency map.

Replication plane (``replication=ReplConfig(...)``, :mod:`metrics_tpu_torch.repl`):
a primary's shipper thread publishes its snapshots and WAL records; a follower
has no dispatcher, and its applier thread replays the shipped records through
the follower's own bucket graphs (bit for bit on the device kind that journaled
them), serves reads within a staleness bound and refuses writes until
:meth:`StreamingEngine.promote` drains the link, fences it at a new epoch and
flips it writable. A bootstrap or rebootstrap restores the shipped snapshot into
the live slab in place, so no captured graph is left reading freed memory.

With obs on (:func:`metrics_tpu_torch.obs.enable`) a submit mints or adopts a
trace context, ``R`` and ``C`` records carry it in the JAX package's 17-byte
trailer, and every replayed record runs inside an ``engine.replay`` span naming
the submitting trace ids; the engine registers a flight-recorder context.

``compute(key, sync=True)`` and ``compute_all(sync=True)`` all-reduce each
tenant's state across processes through the comm plane
(:func:`metrics_tpu_torch.parallel.sync.sync_state_host`, site
``"engine.compute"``; a collection syncs per member), one sync at a time per
engine and outside the dispatch lock, behind the guard's comm breaker as in the
JAX package. Not ported yet: ``rollup`` (ROADMAP A.9), which raises
``NotImplementedError`` naming its item. Reads compute eagerly from a copy of
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
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from metrics_tpu_torch.ckpt import format as ckpt_format
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
from metrics_tpu_torch.guard import EngineQuarantined, GuardConfig, GuardPlane, HangDetector, TenantQuarantined
from metrics_tpu_torch.guard.watchdog import Watchdog
from metrics_tpu_torch.kernels import _tally
from metrics_tpu_torch.kernels.engine_scan import masked_scan_update
from metrics_tpu_torch.metric import Metric, _as_state_tensor
from metrics_tpu_torch.obs import OBS as _OBS
from metrics_tpu_torch.obs import context as _obs_ctx
from metrics_tpu_torch.obs import instrument as _obs
from metrics_tpu_torch.obs.context import TraceContext as _TraceContext
from metrics_tpu_torch.obs.flight import FLIGHT as _FLIGHT
from metrics_tpu_torch.parallel.sync import sync_state_host
from metrics_tpu_torch.repl.config import ReplConfig, ReplicaLag
from metrics_tpu_torch.repl.errors import NotPrimaryError, NotPromotableError, StalenessExceeded
from metrics_tpu_torch.repl.replica import ReplicaApplier
from metrics_tpu_torch.repl.shipper import Shipper
from metrics_tpu_torch.tier import HOT, TierConfig, TierManager, capture_entry, peek_state, restore_entry
from metrics_tpu_torch.tier.residency import capture_entries
from metrics_tpu_torch.utils.checks import traced
from metrics_tpu_torch.utils.device import resolve_device
from metrics_tpu_torch.utils.graphs import capture
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

_POLICIES = ("block", "drop", "timeout")
_WAL_FLUSH = ("none", "flush", "fsync")
_WAL_FSYNC = ("never", "commit", "interval")

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
# - b"D" DEMOTE records (slot + key) — the tier plane moved a tenant out of the
#   slab; replay captures the replayed row into the warm mirror and frees the slot.
# - b"P" PROMOTE records (slot + key + the readmitted entry as an MTCKPT1 blob,
#   empty for a cold-registered tenant with no state) — replay installs the slot
#   and restores the embedded entry, never the spill file the live engine deleted.
#
# With obs on, R and C records end in an optional trace-context trailer: one
# 17-byte block (``obs.context.TraceContext.to_bytes``) per traced request, after
# the positional body. Decoders test the remaining length, so records written
# with obs off replay unchanged; either package reads the other's trailers.

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


def _encode_request_record(
    key_bytes: bytes, args: Tuple[Any, ...], ctx: Optional[_TraceContext] = None
) -> bytes:
    parts = [b"R", _WAL_U32.pack(len(key_bytes)), key_bytes, bytes((len(args),))]
    for a in args:
        _enc_array(parts, _as_numpy(a))
    if ctx is not None:
        parts.append(ctx.to_bytes())  # the optional trace trailer
    return b"".join(parts)


def _decode_request_record(payload: bytes) -> Tuple[Hashable, Tuple[np.ndarray, ...], Optional[_TraceContext]]:
    (klen,) = _WAL_U32.unpack_from(payload, 1)
    off = 1 + _WAL_U32.size + klen
    key = pickle.loads(payload[1 + _WAL_U32.size : off])
    nargs = payload[off]
    off += 1
    args = []
    for _ in range(nargs):
        arr, off = _dec_array(payload, off)
        args.append(arr)
    ctx = _TraceContext.from_bytes(payload, off) if off + _obs_ctx.WIRE_SIZE <= len(payload) else None
    return key, tuple(args), ctx


def _encode_chunk_record(
    new_slots: List[Tuple[int, bytes]],
    key_ids: np.ndarray,
    mask: np.ndarray,
    columns: Sequence[np.ndarray],
    ctxs: Sequence[_TraceContext] = (),
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
    # the optional trailer: one block per traced request the chunk coalesced
    for ctx in ctxs:
        parts.append(ctx.to_bytes())
    return b"".join(parts)


def _record_trace_hexes(payload: bytes) -> str:
    """Comma-joined trace ids of a WAL record's optional trace trailer ("" for
    records without one and for the kinds that never carry one). Walks the
    positional body with offset arithmetic only to find where the trailer
    starts."""
    kind = payload[:1]
    try:
        if kind == b"R":
            (klen,) = _WAL_U32.unpack_from(payload, 1)
            off = 1 + _WAL_U32.size + klen
            nargs = payload[off]
            off += 1
            for _ in range(nargs):
                _, off = _dec_array(payload, off)
        elif kind == b"C":
            (n_new,) = struct.unpack_from("<H", payload, 1)
            off = 3
            for _ in range(n_new):
                off += _WAL_U32.size
                (klen,) = _WAL_U32.unpack_from(payload, off)
                off += _WAL_U32.size + klen
            ncols = payload[off]
            off += 1
            for _ in range(2 + ncols):  # key_ids, mask, columns
                _, off = _dec_array(payload, off)
        else:
            return ""
        return ",".join(c.trace_hex for c in _obs_ctx.iter_wire_blocks(payload, off))
    except Exception:  # noqa: BLE001 — attribution is best-effort; replay decides validity
        return ""


def _encode_tier_record(kind: bytes, slot: int, key_bytes: bytes, blob: bytes = b"") -> bytes:
    """One residency-transition WAL record (kind is b"D" / b"T" / b"P").

    ``blob`` rides only on promote records: the readmitted entry as an
    ``MTCKPT1`` container (empty for a cold-registered tenant that never had
    state — replay then installs a fresh init row)."""
    parts = [kind, _WAL_U32.pack(slot), _WAL_U32.pack(len(key_bytes)), key_bytes]
    if kind == b"P":
        parts.append(_WAL_U32.pack(len(blob)))
        parts.append(blob)
    return b"".join(parts)


def _decode_tier_record(payload: bytes) -> Tuple[int, Hashable, Optional[bytes]]:
    (slot,) = _WAL_U32.unpack_from(payload, 1)
    (klen,) = _WAL_U32.unpack_from(payload, 5)
    off = 9
    key = pickle.loads(payload[off : off + klen])
    off += klen
    blob: Optional[bytes] = None
    if payload[:1] == b"P":
        (blen,) = _WAL_U32.unpack_from(payload, off)
        off += 4
        blob = payload[off : off + blen]
    return slot, key, blob


def _to_device_async(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array copied to ``device`` without waiting for its stream: on the
    card through pinned memory (the caching host allocator does not reuse the
    block before the copy ends), so a replay enqueues without a sync. The host
    array is copied once, into the tensor handed on."""
    if device.type != "cuda":
        return torch.from_numpy(np.array(arr, copy=True)).to(device)
    dtype = torch.from_numpy(np.empty(0, dtype=arr.dtype)).dtype
    pinned = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
    pinned.numpy()[...] = arr
    return pinned.to(device, non_blocking=True)


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


class _WorkerSuperseded(BaseException):
    """Internal: a dispatcher found its epoch stale (a hang takeover superseded
    it) and retires without touching shared state."""


class _Request:
    __slots__ = ("key", "slot", "args", "rows", "signature", "future", "t_submit", "rows_done", "seq",
                 "deadline", "priority", "t_enqueue", "is_probe", "ctx")

    def __init__(self, key: Hashable, slot: Optional[int], args: Tuple[Any, ...],
                 rows: int, signature: Signature, future: "Future", t_submit: float,
                 deadline: Optional[float] = None, priority: int = 0,
                 t_enqueue: float = 0.0, is_probe: bool = False,
                 ctx: Optional[_TraceContext] = None) -> None:
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
        # guard plane: absolute deadline and shed priority on the guard clock,
        # the enqueue stamp sojourn-time shedding reads, and whether this
        # request is a quarantined tenant's single half-open probe (a probe
        # rejected in-queue must free its slot, not wedge the tenant)
        self.deadline = deadline
        self.priority = priority
        self.t_enqueue = t_enqueue
        self.is_probe = is_probe
        self.ctx = ctx  # the request's trace context (obs on), journaled in its trailer


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


class _FirstCalls:
    """The graph kernels' first calls (warm-up and capture) in flight in this
    process. Their wall time grows with how many run at once (a sharded engine's
    shards capture together on one card and share one interpreter), so each
    call's watchdog deadline is stretched by the most that ran beside it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._peaks: Dict[object, int] = {}  # a call in flight -> the most in flight during it

    @contextmanager
    def joined(self) -> Iterator[Callable[[], int]]:
        token = object()
        with self._lock:
            self._peaks[token] = 0
            n = len(self._peaks)
            for t in self._peaks:
                self._peaks[t] = max(self._peaks[t], n)
        try:
            yield lambda: self._peaks.get(token, 1)
        finally:
            with self._lock:
                del self._peaks[token]


_FIRST_CALLS = _FirstCalls()


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

    With the guard's watchdog on (``detector``), the first call counts against
    its deadline stretched by the most first calls in flight beside it
    (:class:`_FirstCalls`): a capture is host work whose time grows with the
    captures around it, and a wedged warm-up or capture is still caught.
    """

    def __init__(self, update_state: Callable, stream: torch.cuda.Stream, pool: Any,
                 detector: Optional[HangDetector] = None) -> None:
        self._update_state = update_state
        self._stream = stream
        self._pool = pool
        self._detector = detector
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
        with _FIRST_CALLS.joined() as crowd:
            if self._detector is None:
                self._build(keyed, key_ids, mask, columns)
            else:
                with self._detector.stretched(crowd):
                    self._build(keyed, key_ids, mask, columns)

    def _build(self, keyed: KeyedState, key_ids: torch.Tensor, mask: torch.Tensor,
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
                with _tally.counting() as captured:  # this thread's launches: other engines capture at once
                    graph, _ = capture(
                        lambda: masked_scan_update(self._update_state, keyed.stacked, kids, msk, cols), self._stream,
                        self._pool,
                    )
                t2 = time.perf_counter()
        except Exception as exc:  # noqa: BLE001 — a host read, an illegal op in capture, a bad request
            raise _FusedUnsupported(repr(exc)) from exc
        self.captured = {k: n for k, n in captured.items() if n}
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
        guard: a :class:`~metrics_tpu_torch.guard.GuardConfig` turns on the guard
            plane: quotas, the fair drain, deadlines and shedding, breakers,
            tenant quarantine and (with ``watchdog_timeout_s``) the watchdog.
        tier: a :class:`~metrics_tpu_torch.tier.TierConfig` turns on the tier
            plane: at most ``hot_capacity`` tenants in the device slab, the rest
            in host RAM and on disk.
        replication: a :class:`~metrics_tpu_torch.repl.ReplConfig` turns on the
            replication plane: ``role="primary"`` (needs ``checkpoint=`` with its
            WAL) ships the durable lineage over ``transport``; ``role="follower"``
            makes a read replica that replays it, refuses writes
            (:class:`~metrics_tpu_torch.repl.NotPrimaryError`) and reads beyond
            its staleness bound, until :meth:`promote`.
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
        guard: Optional[GuardConfig] = None,
        replication: Optional[ReplConfig] = None,
        tier: Optional[TierConfig] = None,
        device: Optional[Any] = None,
        telemetry_labels: Optional[Dict[str, str]] = None,
        start: bool = True,
    ) -> None:
        if not isinstance(metric_or_collection, (Metric, MetricCollection)):
            raise MetricsTPUUserError(
                f"StreamingEngine serves a Metric or MetricCollection, got {type(metric_or_collection)!r}"
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
        # serializes sync=True collective syncs: two readers syncing different
        # tenants concurrently would issue cross-process collectives in
        # whatever order their threads race to — ranks disagreeing on that
        # order deadlocks (or cross-wires) the job
        self._sync_state_lock = threading.Lock()
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
        self._fused_error: Optional[BaseException] = None  # the last capture failure, if any
        self._keyed: Union[KeyedState, EagerKeyedState] = (
            KeyedState(self._metric, capacity=capacity, window=window)
            if self._fused
            else EagerKeyedState(self._metric, window=window)
        )
        self._window = window

        # tier plane: None-checked on every hot path — an untiered engine pays
        # one attribute test per drained batch and nothing per request.
        # _tier_policy tells a configured tier (the eviction pass runs) from one
        # made lazily by the replay or restore of residency records (mechanics
        # only: nothing is demoted until a policy is configured).
        self._tier: Optional[TierManager] = TierManager(tier, self._metric) if tier is not None else None
        self._tier_policy = tier is not None

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
        self._quarantined = False  # a hung worker wedged in a device call: fail fast
        self._worker_error: Optional[BaseException] = None
        # dispatcher generations: a hang takeover supersedes a worker by bumping
        # the epoch; a worker re-checks its epoch wherever it touches shared
        # state (under the dispatch lock before any replay) and retires if stale
        self._worker_epoch = 0
        self._worker_restarts = 0
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
        # guard plane (None-checked on every hot path, like checkpointing)
        self._guard: Optional[GuardPlane] = None
        self._hang_detector: Optional[HangDetector] = None
        self._watchdog: Optional[Watchdog] = None
        if guard is not None:
            self._guard = GuardPlane(guard, telemetry=self.telemetry, max_rows=self._max_rows)
            if guard.watchdog_timeout_s is not None:
                self._hang_detector = HangDetector(guard.watchdog_timeout_s, clock=guard.clock)
                self._watchdog = Watchdog(self._hang_detector.hung, self._on_worker_hang,
                                          poll_s=guard.watchdog_poll_s)
        self._last_health_state = "SERVING"  # the on_health_transition hook's edge detector
        # replication plane: a primary ships its snapshot + WAL lineage off-thread;
        # a follower is a read replica whose applier thread replays it
        self._repl_cfg: Optional[ReplConfig] = None
        self._shipper: Optional[Shipper] = None
        self._applier: Optional[ReplicaApplier] = None
        self._repl_follower = False
        self._repl_epoch = 0
        self._promote_lock = threading.Lock()
        # cluster plane (metrics_tpu_torch.cluster / .part): the supervising
        # ClusterNode or PartitionedNode registers itself here, so health()
        # carries a `cluster` section and a second supervisor is refused
        self._cluster: Optional[Any] = None
        if replication is not None and replication.role == "follower" and checkpoint is not None:
            raise MetricsTPUUserError(
                "a follower replica does not own a durable lineage while following — its state "
                "is the primary's, re-bootstrappable from the ship link. Configure the lineage "
                "it should open AT PROMOTION via ReplConfig(promote_checkpoint=CheckpointConfig(...))"
            )
        try:
            if checkpoint is not None:
                self._init_checkpoint(checkpoint)
            if replication is not None:
                self._init_replication(replication)
        except BaseException:
            if self._watchdog is not None:
                self._watchdog.stop()
            if self._ckpt_writer is not None:
                self._ckpt_writer.close()
            if self._journal is not None:
                self._journal.close()
            raise

        # flight-recorder context provider: a dump may run while a trigger site
        # holds guard or engine locks, so it reads bare attributes only
        self._flight_provider_name = f"engine:{self.telemetry.engine_id}"
        _FLIGHT.register_provider(self._flight_provider_name, self._flight_context)

        self._worker: Optional[threading.Thread] = None
        if start and not self._repl_follower:
            # a follower has no dispatcher: its applier owns the state until
            # promote() flips it writable (which starts one)
            self.start()

    # ------------------------------------------------------------------ lifecycle

    def start(self) -> None:
        with self._lock:
            if self._worker is not None or self._closed:
                return
            self._spawn_worker()

    def _spawn_worker(self) -> None:
        """Start a dispatcher thread for the CURRENT epoch (caller holds the lock)."""
        self._worker = threading.Thread(
            target=self._run, args=(self._worker_epoch,), name="metrics-tpu-torch-engine-dispatch", daemon=True
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
        if flush and not self._quarantined:
            self.flush()
        if flush and checkpoint and self._ckpt_writer is not None and not self._quarantined:
            # a quarantined engine's dispatch lock may be held by the wedged
            # worker forever: taking a final snapshot would hang close()
            self._ckpt_writer.checkpoint_sync(self._checkpoint_view)
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()
            self._idle.notify_all()
            worker = self._worker
        if self._watchdog is not None:
            self._watchdog.stop()
        if self._shipper is not None:
            self._shipper.close()  # one final publish of what the final checkpoint left
        if self._applier is not None:
            self._applier.stop()
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
        self._publish_health()
        _FLIGHT.unregister_provider(self._flight_provider_name)
        if self._ckpt_writer is not None:
            self._ckpt_writer.close()
        if self._journal is not None:
            self._journal.close()

    def _flight_context(self) -> Dict[str, Any]:
        """Post-mortem context for flight-recorder bundles. Lock-free by
        contract (bundles are dumped at trigger sites that may hold guard or
        engine locks): bare attribute reads only."""
        return {
            "engine": self.telemetry.engine_id,
            "wal_seq": self._wal_seq,
            "health_state": self._last_health_state,
            "queue_depth": len(self._queue),
            "worker_restarts": self._worker_restarts,
            "zombie_workers": self._zombie_workers,
            "degraded": self._degraded,
            "quarantined": self._quarantined,
            "closed": self._closed,
            "repl_follower": self._repl_follower,
            "repl_epoch": self._repl_epoch,
        }

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

    def submit(self, key: Hashable, *args: Any, deadline: Optional[float] = None, priority: int = 0) -> "Future":
        """Enqueue one update for tenant ``key``; resolves to a receipt dict
        (``key``, ``rows``, ``bucket``) once the state update has committed.

        Raises :class:`EngineBackpressure` per the configured policy when the queue is
        full, and :class:`EngineClosed` after :meth:`close`. With a guard plane
        (``guard=GuardConfig(...)``): ``deadline`` (seconds from now) makes the
        request fail fast with :class:`~metrics_tpu_torch.guard.DeadlineExceeded`
        if it expires before dispatch; ``priority`` orders overload shedding
        (requests at or below the configured shed priority may be dropped under
        standing overload); quota-exhausted and quarantined tenants are refused
        at entry (:class:`~metrics_tpu_torch.guard.QuotaExceeded`,
        :class:`~metrics_tpu_torch.guard.TenantQuarantined`); a quarantined engine
        refuses everything with :class:`~metrics_tpu_torch.guard.EngineQuarantined`.
        A follower replica refuses every submit with
        :class:`~metrics_tpu_torch.repl.NotPrimaryError`.
        """
        if self._repl_follower:
            raise NotPrimaryError(
                "submit() on a follower replica: writes go to the primary; this engine serves "
                "bounded-staleness reads until promote() flips it writable"
            )
        t_submit = time.perf_counter()
        # trace context: adopt the ambient one (a caller's activate()) or mint a
        # fresh root; an obs-off submit carries None after one attribute test
        ctx = _obs_ctx.mint_or_current() if _OBS.enabled else None
        rows, signature = inspect_request(args)
        guard = self._guard
        abs_deadline: Optional[float] = None
        t_enqueue = 0.0
        is_probe = False
        if guard is not None:
            if self._quarantined:
                raise EngineQuarantined("submit() on a quarantined StreamingEngine (dispatcher wedged in a device call)")
            # full admission only when there is something to check: a guarded
            # submit with no quotas, no deadline and a clean quarantine ledger
            # costs attribute loads, not calls
            if deadline is not None or guard.admission_active or guard._quarantine_entries:
                abs_deadline, is_probe = guard.admit(key, rows, deadline)
            if guard.stamp_enqueue:
                # the default guard clock IS perf_counter: reuse the entry stamp
                t_enqueue = t_submit if guard.clock is time.perf_counter else guard.clock()
        try:
            future: Future = Future()
            with self._not_full:
                if self._closed:
                    raise EngineClosed("submit() on a closed StreamingEngine")
                self._check_admissible(key)
                if self._degraded or self._worker is None:
                    # synchronous per-call dispatch (dispatcher dead or never started)
                    req = _Request(key, self._alloc_slot(key), tuple(args), rows, signature, future, t_submit,
                                   abs_deadline, priority, t_enqueue, is_probe, ctx)
                    self.telemetry.count("submitted")
                    self._apply_inline(req)
                    return future
                backlog = guard.backlog if guard is not None else None
                wait_deadline = time.monotonic() + self._submit_timeout
                while len(self._queue) + (backlog.count if backlog is not None else 0) >= self._max_queue:
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
                    if self._quarantined:
                        raise EngineQuarantined("StreamingEngine quarantined while waiting for queue space")
                    if self._degraded:
                        req = _Request(key, self._alloc_slot(key), tuple(args), rows, signature, future, t_submit,
                                       abs_deadline, priority, t_enqueue, is_probe, ctx)
                        self.telemetry.count("submitted")
                        self._apply_inline(req)
                        return future
                # the backpressure wait released the lock: a hold may have landed
                self._check_admissible(key)
                req = _Request(key, self._alloc_slot(key), tuple(args), rows, signature, future, t_submit,
                               abs_deadline, priority, t_enqueue, is_probe, ctx)
                self._queue.append(req)
                self.telemetry.count("submitted")
                self.telemetry.gauge_queue_depth(len(self._queue))
                self._not_empty.notify()
            return future
        except Exception:
            if is_probe:
                # the admitted quarantine probe never reached processing: free
                # the probe slot so the tenant is not wedged in probation
                guard.abandon_probe(key)
            raise

    def _check_admissible(self, key: Hashable) -> None:
        """The checks ``submit`` repeats under the engine lock: an engine
        quarantined, or a tenant held (a migration in flight), since admission."""
        if self._quarantined:
            raise EngineQuarantined("submit() on a quarantined StreamingEngine (dispatcher wedged in a device call)")
        guard = self._guard
        if guard is not None and guard.quarantine.is_held(key):
            # refused synchronously, or this row would commit on the source
            # after the drain barrier exported the tenant
            raise TenantQuarantined(f"tenant {key!r} is held (migration in flight); "
                                    "reload the partition map and resubmit")

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until every accepted request has committed (or ``timeout`` elapses).

        Holds through a worker death too: the death handler keeps ``_inflight`` equal
        to the number of accepted-but-unreplayed requests while it replays them
        inline, so 'accepted implies committed after flush' survives degradation.
        The guard's backlog counts as accepted work.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        backlog = self._guard.backlog if self._guard is not None else None
        with self._idle:
            while self._queue or self._inflight or (backlog is not None and backlog.count):
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
        backlog = self._guard.backlog if self._guard is not None else None
        with self._idle:
            while True:
                pending = any(req.key == key for req in self._queue)
                if not pending and self._active_batch is not None:
                    pending = any(req.key == key for req in self._active_batch)
                if not pending and backlog is not None and backlog.count:
                    pending = backlog.pending_for(key) > 0
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
        """Forget ``key`` entirely: its state, its window history and its
        residency records. Returns False for an unknown key.

        Waits out only this key's accepted requests (not the whole engine), then,
        under the dispatch lock, journals the retirement (``b"T"``) BEFORE the slot
        id returns to the free list — so WAL replay reproduces retire-then-reuse in
        commit order and a recovered engine never aliases the freed row onto
        whichever new tenant reused it — scrubs the tenant's rows to their initial
        values and frees the slot, where the next new tenant takes it. Works on
        untiered engines too. The slab is written in place, so the captured graphs
        stay valid.
        """
        self._check_quarantined("evict_tenant")
        self._check_writable("evict_tenant")
        self.drain_tenant(key)
        with self._dispatch_lock, self._on_stream():
            resident = self._is_resident(key)
            tiered = self._tier is not None and self._tier.has(key)
            if not resident and not tiered:
                return False
            self._retire(key)
            self._sync()
        self.telemetry.count("tier_evictions")
        return True

    def _retire(self, key: Hashable) -> None:
        """Journal ``b"T"``, then forget ``key`` in every tier and free its slot
        (caller holds the dispatch lock, on the engine's stream)."""
        keyed = self._keyed
        if self._journal is not None:
            slot = keyed._slots.get(key, 0) if isinstance(keyed, KeyedState) else 0
            self._journal_append([_encode_tier_record(b"T", int(slot), self._key_bytes(key))])
        tier = self._tier
        if tier is not None:
            tier.discard(key)
            tier.forget_heat(key)
            tier.pinned.discard(key)
        if self._is_resident(key):
            slot = keyed.evict(key)
            keyed.release_slot(slot)
            if slot is not None:
                self._wal_slots_sent.discard(slot)

    def export_tenant(self, key: Hashable, *, retire: bool = True) -> Optional[Dict[str, Any]]:
        """Capture one tenant's full entry, whatever tier it occupies (numpy
        leaves, the JAX package's entry layout). Returns ``None`` for an unknown key.

        With ``retire=True`` the tenant is also forgotten here, journaled like
        :meth:`evict_tenant` so a recovered engine agrees it left. With
        ``retire=False`` the capture is a pure read (no journal record, no
        eviction): the caller retires the source copy once the destination's is
        durable."""
        self._check_quarantined("export_tenant")
        with self._dispatch_lock, self._on_stream():
            keyed = self._keyed
            if self._is_resident(key):
                entry = capture_entry(keyed, key)
            elif self._tier is not None and self._tier.has(key):
                peeked = self._tier.peek_entry(key)
                entry = dict(peeked) if peeked is not None else {"state": None, "ring": [], "rot": int(keyed.rotations)}
            else:
                return None
            entry.pop("_spill_file", None)
            if not retire:
                return entry
            self._retire(key)
            self._sync()
        self.telemetry.count("tier_evictions")
        return entry

    def import_tenant(self, key: Hashable, entry: Optional[Dict[str, Any]]) -> None:
        """Install an exported tenant entry (from either package).

        Exports are captured live, so their ring rows occupy the last
        ``len(ring)`` source segments; re-stamping the entry with THIS engine's
        rotation counter places them in the same positions relative to this
        window (an empty ring is padded with init segments first to give the
        rows somewhere to land). An entry with no state at all (a
        registered-but-silent cold tenant) stays off the slab when this engine
        is tiered — it lands as a cold registration. A resident entry is written
        into the tenant's slab row in place, journaled as a ``b"P"`` record."""
        self._check_quarantined("import_tenant")
        self._check_writable("import_tenant")
        with self._dispatch_lock, self._on_stream():
            keyed = self._keyed
            rows: List[Any] = []
            if entry is not None:
                entry = dict(entry)
                entry.pop("_spill_file", None)
                entry["rot"] = int(keyed.rotations)
                rows = list(entry.get("ring") or [])
            empty = entry is None or (entry.get("state") is None and not any(r is not None for r in rows))
            if empty and self._tier is not None and not self._is_resident(key):
                self._tier.discard(key)
                self._tier.register_cold(key)
                return
            ring = keyed._ring
            if rows and ring is not None and len(ring) < len(rows):
                while len(ring) < len(rows):
                    if isinstance(keyed, KeyedState):
                        ring.append((keyed.capacity, tree_unflatten(keyed._tiled(keyed.capacity), keyed._treedef)))
                    else:
                        ring.append({})
            slot = keyed.slot_for(key)
            self._grow()
            if self._journal is not None:
                blob = b"" if entry is None else ckpt_format.dumps(entry, meta={"kind": "tier-promote"})
                self._journal_append([_encode_tier_record(b"P", int(slot or 0), self._key_bytes(key), blob)])
                if slot is not None:
                    self._wal_slots_sent.add(slot)
            if self._tier is not None:
                self._tier.discard(key)
            if entry is not None:
                restore_entry(keyed, key, entry)
            self._sync()

    def _read_states(self, keys: Optional[Sequence[Hashable]], window: bool) -> Dict[Hashable, Any]:
        """Copies of the tenants' states, enqueued under the dispatch lock on the
        caller's stream, which first waits for the engine's stream. With a fused
        slab the engine's stream then waits for the copies, so no later replay can
        overwrite the slab under a copy still in flight, and the caller
        synchronises its stream after releasing the lock (the lock is held for the
        enqueue only, as the JAX package holds it for a read's dispatch). Eager
        states are no copies (``EagerKeyedState.state_of`` returns the live
        tensors), so their reads synchronise under the lock. A non-resident tenant
        is read from its warm or cold entry without readmission (a sweep over a
        million cold tenants must not thrash the hot set); ``keys=None`` reads
        every tenant, resident ones first."""
        with self._dispatch_lock:
            keyed, tier = self._keyed, self._tier
            if keys is None:
                keys = list(keyed.keys)
                if tier is not None:
                    keys += [key for key in tier.keys() if not self._is_resident(key)]
            for key in keys:
                if not self._is_resident(key) and (tier is None or not tier.has(key)):
                    raise KeyError(f"unknown tenant key {key!r}")

            def read(key: Hashable) -> Any:
                if self._is_resident(key):
                    return keyed.merged_state(key) if window else keyed.state_of(key)
                return peek_state(self._metric, keyed, tier.peek_entry(key) or {}, window=window)

            if self._stream is None:
                return {key: read(key) for key in keys}
            with torch.cuda.device(self._device):
                current = torch.cuda.current_stream()
                current.wait_stream(self._stream)
                states = {key: read(key) for key in keys}
                if not isinstance(keyed, KeyedState):
                    current.synchronize()
                    return states
                # later slab writes (on the engine's stream) wait for these copies, and
                # the slab's memory is not reused before they end
                self._stream.wait_stream(current)
                for leaf in self._slab_leaves():
                    leaf.record_stream(current)
        current.synchronize()  # outside the lock: a read never holds a replay back while it waits
        return states

    def _check_read(self, op: str, window: bool) -> None:
        if window and self._window is None:
            # a silent fall-through would return unbounded lifetime accumulation
            # mislabeled as a sliding-window value
            raise MetricsTPUUserError(f"{op}(window=True) requires the engine to be built with `window=`")

    def compute(self, key: Hashable, *, window: bool = False, sync: bool = False) -> Any:
        """Final metric value for tenant ``key`` (flushes first).

        ``window=True`` computes over the sliding window (requires ``window=`` at
        construction); ``sync=True`` all-reduces the state across processes first
        (multi-process serving), via :func:`metrics_tpu_torch.parallel.sync.sync_state_host`,
        after the read's copy and outside the dispatch lock.
        """
        self._check_read("compute", window)
        self._check_quarantined("compute")
        self._check_staleness()
        self.flush()
        state = self._read_states([key], window)[key]
        if sync:
            state = self._sync_state(state)
        with self._read_lock:
            return self._read_metric.compute_from(state)

    def compute_all(self, *, window: bool = False, sync: bool = False) -> Dict[Hashable, Any]:
        """``compute`` for every known tenant key — one flush, one consistent snapshot
        (every state is copied under one dispatch-lock acquisition); with
        ``sync=True`` each tenant's state is synced in the engine's key order,
        which must be the same on every rank (every rank issues its collectives
        in that order)."""
        self._check_read("compute_all", window)
        self._check_quarantined("compute_all")
        self._check_staleness()
        self.flush()
        states = self._read_states(None, window)
        out: Dict[Hashable, Any] = {}
        for key, state in states.items():
            if sync:
                state = self._sync_state(state)
            with self._read_lock:
                out[key] = self._read_metric.compute_from(state)
        return out

    def _sync_state(self, state: Any) -> Any:
        # one collective sync at a time per process (_sync_state_lock): every
        # rank must issue collectives in the same order, and the breaker's
        # last_report() judging below must not see another call's report. It
        # runs outside the dispatch lock: a rank that waits for a peer must
        # not hold back its own dispatcher
        with self._sync_state_lock:
            return self._sync_state_inner(state)

    def _sync_state_inner(self, state: Any) -> Any:
        # multi-process serving rides the comm plane (codecs, coalesced
        # transfers, retry/degradation ladder) with its own site label so engine
        # syncs are attributable separately from bare sync_state_host callers
        guard = self._guard
        breaker = guard.comm_breaker if guard is not None else None
        if breaker is not None and not breaker.permit():
            # repeated degraded/stale syncs: pin sync=False for the probation —
            # local state NOW beats a retry ladder walk that ends stale anyway
            self.telemetry.count("sync_pinned")
            return state
        from metrics_tpu_torch.comm import plane as _comm_plane

        # only reports THIS call produced may judge the breaker: the
        # single-process identity path publishes nothing, and a stale report
        # from an earlier sync must not re-trip a healthy probe. For a
        # collection, EVERY member's sync is judged — one member walking the
        # ladder to stale local state makes the whole result partially stale.
        prev = _comm_plane.last_report() if breaker is not None else None
        degraded = False
        conclusive = False

        def _judge() -> None:
            nonlocal prev, degraded, conclusive
            report = _comm_plane.last_report()
            if report is not None and report is not prev and report.site == "engine.compute":
                conclusive = True
                # live_subset is a SUCCESSFUL sync over the agreed surviving
                # ranks — exact for cumulative state, not stale. Tripping the
                # breaker on it would pin sync=False and turn one dead peer
                # into N disjoint local aggregates, which is strictly worse.
                if report.stale or report.degraded_step not in ("none", "live_subset"):
                    degraded = True
            prev = report

        try:
            if isinstance(self._metric, MetricCollection):
                synced = {}
                for name, sub in state.items():
                    synced[name] = sync_state_host(
                        sub, self._metric._modules[name]._reductions, site="engine.compute"
                    )
                    if breaker is not None:
                        _judge()
            else:
                synced = sync_state_host(state, self._metric._reductions, site="engine.compute")
                if breaker is not None:
                    _judge()
        except Exception:
            if breaker is not None:
                breaker.record_failure()
            raise
        if breaker is not None:
            if degraded:
                breaker.record_failure()
            elif conclusive:
                breaker.record_success()
            else:
                breaker.abandon_probe()
        return synced

    def rollup(self, *, window: bool = False) -> Any:
        """Fold EVERY local tenant into one mergeable state, stamped for the cache.

        The global-query read primitive (:mod:`metrics_tpu_torch.query`): one
        watermark-stamped :class:`~metrics_tpu_torch.query.rollup.PartitionRollup`
        per partition replaces a per-tenant scatter. Served by followers too
        (under the staleness gate) — the fold never mutates state, never changes
        tier residency, and never touches the write path beyond the same flush
        ``compute`` pays.

        The slab is written in place here (graphs are bound to its addresses), so
        unlike the JAX package, which folds an immutable slab off-lock, the fold is
        enqueued on the engine's stream under the dispatch lock, the ordering
        :meth:`_read_states` uses: it reads the slab after every replay before it
        and before every replay after it. The watermark is read first through
        :meth:`wal_watermark` (its gates and its lock order) and, on a primary,
        read again in the fold's lock window: journaling happens under that lock,
        so within one epoch the second read is exactly the seq the fold covers. On
        a follower (whose applier advances its seq outside the dispatch lock) and
        across an epoch change the first read stands, which can only under-claim
        the fold's coverage: revalidation then invalidates early, never serves a
        stamp the state does not back. Only live ring slots are gathered (a
        demoted tenant's ring rows survive until ``release_slot`` scrubs them, and
        its history already lives in its tier entry); non-resident tenants are
        peeked from their entries, and a registered tenant with no entry counts
        toward ``tenants`` but is not folded (its state is the fold identity).
        """
        from metrics_tpu_torch.query.rollup import PartitionRollup, fold_slab, fold_states, merge_folds

        if window and self._window is None:
            raise MetricsTPUUserError("rollup(window=True) requires the engine to be built with `window=`")
        self._check_quarantined("rollup")
        self._check_staleness()
        if self._closed:
            raise EngineClosed("rollup() on a closed StreamingEngine")
        self.flush()
        t0 = time.monotonic()
        watermark = self.wal_watermark()
        folds: List[Any] = []
        current = torch.cuda.current_stream(self._device) if self._stream is not None else None
        with self._dispatch_lock, self._on_stream():
            if not self._repl_follower and int(self._repl_epoch) == watermark[0]:
                watermark = (watermark[0], int(self._wal_seq))
            keyed = self._keyed
            tenants = len(keyed.keys)
            if isinstance(keyed, KeyedState):
                if window and keyed._ring:
                    slots = sorted(s for s in keyed._slots.values() if s < keyed.capacity)
                    for cap, snap in keyed._ring:  # oldest segment first, matching merged_state
                        idx = [s for s in slots if s < cap]
                        if idx:
                            rows = torch.tensor(idx, dtype=torch.int64).to(keyed.leaves()[0].device)
                            folds.append(fold_slab(self._metric, tree_map(lambda x: x.index_select(0, rows), snap)))
                # free + never-dispatched rows hold init values — the reduction
                # identities — so the whole-slab fold needs no residency mask
                folds.append(fold_slab(self._metric, keyed.stacked))
            else:
                eager = [keyed.merged_state(key) if window else keyed.state_of(key) for key in keyed.keys]
                if eager:
                    folds.append(fold_states(self._metric, eager))
            tier = self._tier
            if tier is not None:
                resident = set(keyed.keys)
                peeked = []
                for key in tier.keys():
                    if key in resident:
                        continue
                    tenants += 1
                    entry = tier.peek_entry(key)
                    # a registered-but-silent cold tenant has no entry at all: it
                    # counts toward coverage and contributes nothing, which keeps a
                    # million-registered-tenant rollup O(tenants with state)
                    if entry:
                        peeked.append(peek_state(self._metric, keyed, entry, window=window))
                if peeked:
                    folds.append(fold_states(self._metric, peeked))
            state = merge_folds(self._metric, folds)
            if self._stream is not None:
                done = torch.cuda.Event()
                done.record(self._stream)
        if self._stream is not None:
            # outside the lock, like a read: the caller's stream takes the fold
            # once the engine's stream has produced it
            done.synchronize()
            for leaf in tree_flatten(state)[0]:
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                    leaf.record_stream(current)
        lag = self.replica_lag()
        _obs.record_query_rollup_seconds(self.telemetry.engine_id, time.monotonic() - t0)
        return PartitionRollup(
            partition=self.telemetry.label("partition"),
            state=state,
            watermark=watermark,
            tenants=tenants,
            follower=self._repl_follower,
            node=self.telemetry.engine_id,
            staleness_seqs=None if lag is None else lag.seqs_behind,
            staleness_s=None if lag is None else lag.seconds_behind,
        )

    def wal_watermark(self) -> Tuple[int, int]:
        """``(epoch, seq)`` — this engine's WAL position in its lineage.

        On a primary: the lineage epoch and the last journaled seq, read under
        the promote lock so a concurrent role flip cannot tear a (new epoch, old
        seq) pair. On a follower: the applier's applied position, behind the same
        staleness gate as every other follower read. ``seq`` is ``-1`` with no
        journaled write yet (or no durable plane at all). An engine whose
        telemetry carries a ``partition`` label (stamped when a
        ``PartitionedNode`` adopts it) also sets that partition's WAL-seq gauge."""
        if self._closed:
            raise EngineClosed("wal_watermark() on a closed StreamingEngine")
        self._check_quarantined("wal_watermark")
        self._check_staleness()
        applier = self._applier
        if self._repl_follower and applier is not None:
            wm = applier.watermark()
        else:
            with self._promote_lock:
                wm = (int(self._repl_epoch), int(self._wal_seq))
        partition = self.telemetry.label("partition")
        if partition:
            _obs.set_part_wal_seq(self.telemetry.engine_id, partition, wm[1])
        return wm

    def _check_quarantined(self, op: str) -> None:
        """Fail fast instead of deadlocking on a dispatch lock a wedged worker holds."""
        if self._quarantined:
            raise EngineQuarantined(f"{op}() on a quarantined StreamingEngine (dispatcher wedged in a device call)")

    def _check_writable(self, op: str) -> None:
        if self._repl_follower:
            raise NotPrimaryError(
                f"{op}() on a follower replica: its state mirrors the primary's and is "
                "mutated only by replay (promote() flips this engine writable)"
            )

    def rotate_window(self) -> None:
        """Close the current sliding-window segment for ALL tenants (flushes first)."""
        self._check_quarantined("rotate_window")
        self._check_writable("rotate_window")
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
        """Drop all tenant state (keys stay allocated; non-resident tenants become
        cold with an initial state). The slab is written in place, so captured
        graphs stay valid."""
        self._check_quarantined("reset")
        self._check_writable("reset")
        self.flush()
        orphans: List[str] = []
        with self._dispatch_lock, self._on_stream():
            if self._journal is not None:
                self._journal_append([b"Z"])
            self._keyed.reset()
            if self._tier is not None:
                # their spill files are orphans once the reset is journaled
                orphans = self._tier.reset()
            self._sync()
        if self._tier is not None and self._tier.store is not None:
            for name in orphans:
                self._tier.store.delete(name)

    @property
    def fused(self) -> bool:
        """True while the engine serves through the micro-batch kernels."""
        return self._fused

    @property
    def degraded(self) -> bool:
        """True once the dispatcher died and submits run inline."""
        return self._degraded

    @property
    def quarantined(self) -> bool:
        """True once a hung dispatcher could not be safely superseded (it holds
        the dispatch lock, inside a device call): the engine fails fast instead
        of hanging callers."""
        return self._quarantined

    @property
    def device(self) -> torch.device:
        return self._device

    def health(self) -> Dict[str, Any]:
        """The engine's health state machine, one plain dict, with the JAX
        package's keys.

        ``state`` walks ``SERVING → DEGRADED → QUARANTINED``: ``DEGRADED`` once the
        dispatcher died and submits run inline, a circuit breaker is open, the
        overload controller is shedding, the WAL was disabled after an IO
        failure, a zombie worker survived ``close()``, the shipper was fenced (a
        deposed primary) or a ship or apply loop keeps failing; ``QUARANTINED``
        once a hung dispatcher could not be superseded (the guard's watchdog). A
        guard plane's ``on_health_transition`` hook is called once per edge,
        outside the engine's locks. With replication, ``"replication"`` holds
        the role, epoch, positions and lag; under a ``ClusterNode`` or
        ``PartitionedNode``, ``"cluster"`` holds its ``health_view()``.
        """
        with self._lock:
            quarantined = self._quarantined
            degraded = self._degraded
            zombies = self._zombie_workers
            worker = self._worker
            closed = self._closed
            restarts = self._worker_restarts
            queue_depth = len(self._queue)
            if self._guard is not None:
                queue_depth += self._guard.backlog.count
        guard = self._guard
        breakers = guard.breaker_snapshots() if guard is not None else {}
        shedding = guard.shedding if guard is not None else False
        wal_disabled = self._wal_error is not None
        # a fenced shipper is a deposed primary still serving local writes
        # (split-brain territory): loudly DEGRADED
        repl_fenced = self._shipper is not None and self._shipper.fenced
        # a failing ship or apply loop records its error and clears it on the
        # next clean pass: surface it, or a dead link stays invisible until
        # staleness bites the readers. The applier's error counts only while
        # this engine IS a follower (a promotion freezes the last one recorded)
        repl_link_error = (self._shipper is not None and self._shipper.last_error is not None) or (
            self._repl_follower and self._applier is not None and self._applier.last_error is not None
        )
        if quarantined:
            state = "QUARANTINED"
        elif (degraded or zombies or shedding or wal_disabled or repl_fenced or repl_link_error
              or any(snap["state"] != "closed" for snap in breakers.values())):
            state = "DEGRADED"
        else:
            state = "SERVING"
        out = {
            "state": state,
            "closed": closed,
            "worker_alive": worker is not None and worker.is_alive() and not degraded,
            "worker_restarts": restarts,
            "zombie_workers": zombies,
            "queue_depth": queue_depth,
            "shedding": shedding,
            "wal_disabled": wal_disabled,
            "breakers": breakers,
            "quarantined_tenants": dict(guard.quarantine.active()) if guard is not None else {},
        }
        if self._repl_cfg is not None:
            out["replication"] = self._replication_health()
        cluster = self._cluster
        if cluster is not None:
            out["cluster"] = cluster.health_view()
        if guard is not None:
            guard.publish_health(state)
        # detected under the lock (once per transition, however many readers
        # see it), fired outside every lock, errors absorbed but not hidden
        hook_args: Optional[Tuple[str, str]] = None
        with self._lock:
            if state != self._last_health_state:
                hook_args = (self._last_health_state, state)
                self._last_health_state = state
        if hook_args is not None and _OBS.enabled:
            # the flight recorder's trail (a bundle on QUARANTINED), on the same
            # once-per-edge detection the user hook rides
            _obs.record_health_transition(self.telemetry.engine_id, *hook_args)
        if hook_args is not None and guard is not None and guard.cfg.on_health_transition is not None:
            try:
                guard.cfg.on_health_transition(*hook_args)
            except Exception as exc:  # noqa: BLE001 — an observer crash must not poison health reads
                warnings.warn(
                    f"on_health_transition({hook_args[0]!r} -> {hook_args[1]!r}) raised "
                    f"{type(exc).__name__}: {exc} — the transition will not re-fire; if this "
                    "was the replication failover hook, promote the follower manually",
                    RuntimeWarning,
                    stacklevel=2,
                )
        return out

    def _publish_health(self) -> None:
        """Refresh the health gauge and the transition hook after a state
        change (nothing without a guard plane)."""
        if self._guard is not None:
            self.health()

    def telemetry_snapshot(self) -> Dict[str, Any]:
        snap = self.telemetry.snapshot()
        snap["fused"] = self._fused
        snap["degraded"] = self._degraded
        snap["quarantined"] = self._quarantined
        snap["tenants"] = len(self._keyed.keys)
        tier = self._tier
        if tier is not None:
            snap["tenants"] += len(tier.warm) + len(tier.cold)
            snap["tier"] = {"hot": len(self._keyed.keys), "warm": len(tier.warm), "cold": len(tier.cold),
                            "pinned": len(tier.pinned)}
        if isinstance(self._keyed, KeyedState):
            snap["slab_bytes"] = sum(self._slab_bytes().values())
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

    def _slab_bytes(self) -> Dict[str, int]:
        """Device bytes held by the stacked slab (live + ring), per dtype, from
        the tensors' sizes."""
        out: Dict[str, int] = {}
        if not isinstance(self._keyed, KeyedState):
            return out
        for leaf in self._slab_leaves():
            name = dtype_name(leaf)
            out[name] = out.get(name, 0) + leaf.numel() * leaf.element_size()
        return out

    def _alloc_slot(self, key: Hashable) -> Optional[int]:
        tier = self._tier
        if tier is not None and not self._is_resident(key) and tier.has(key):
            # non-resident tenant: the slot stays unresolved — the dispatcher
            # readmits it under the dispatch lock right before the micro-batch
            # that needs the row (no disk IO or slab writes on the submit path)
            return None
        return self._keyed.slot_for(key)

    def _is_resident(self, key: Hashable) -> bool:
        """O(1) hot-tier membership (``keyed.keys`` materialises a tuple)."""
        keyed = self._keyed
        table = keyed._slots if isinstance(keyed, KeyedState) else keyed._states
        return key in table

    def _grow(self, min_slots: Optional[int] = None) -> None:
        """Grow the slab to fit every allocated slot (caller holds the dispatch
        lock): counted, and the graphs of the old capacity dropped."""
        if self._keyed.ensure_capacity(min_slots=min_slots):
            self.telemetry.count("key_growths")
            self.telemetry.observe_resize(self._keyed.last_resize_s)
            self._drop_stale_graphs()

    def _run(self, epoch: int = 0) -> None:
        detector = self._hang_detector
        backlog = self._guard.backlog if self._guard is not None else None
        while True:
            with self._not_empty:
                while (not self._queue and not (backlog is not None and backlog.count)
                       and not self._closed and self._worker_epoch == epoch):
                    self._not_empty.wait(0.1)
                if self._worker_epoch != epoch:
                    return  # superseded while idle: a fresh generation owns the queue
                if not self._queue and not (backlog is not None and backlog.count) and self._closed:
                    return
                if self._guard is not None:
                    # the arrival queue moves into the guard's fair backlog;
                    # selection costs O(quantum), never O(backlog)
                    batch, rejected = self._guard.form_drain(self._queue)
                else:
                    batch, rejected = self._queue, []
                self._queue = []
                self._inflight = len(batch)
                # a hang takeover replays exactly this list (minus resolved futures)
                self._active_batch = batch
                self.telemetry.gauge_queue_depth(backlog.count if backlog is not None else 0)
                self._not_full.notify_all()
                if not batch and not (backlog is not None and backlog.count):
                    self._idle.notify_all()
            if detector is not None:
                detector.mark_busy()
            # fail expired and shed requests fast, outside the engine lock (future
            # callbacks run arbitrary user code)
            for req, exc in rejected:
                self.telemetry.count("failed")
                req.future.set_exception(exc)
            if not batch:
                if detector is not None:
                    detector.mark_idle()
                continue
            self._worker_gate.wait()
            with self._lock:
                if self._worker_epoch != epoch:
                    return  # declared hung at the gate: the takeover owns the batch now
            try:
                self._process(batch, epoch)
                with self._lock:
                    if self._worker_epoch != epoch:
                        return  # superseded mid-batch: the takeover owns the accounting
                    self._active_batch = None
                    self._inflight = 0
                    self._idle.notify_all()
                self._maybe_checkpoint()
                self._maybe_tier()
                if detector is not None:
                    detector.mark_idle()
            except _WorkerSuperseded:
                return
            except BaseException as exc:  # noqa: BLE001 — dispatcher death: degrade, don't lose work
                self._on_worker_death(exc, batch, epoch)
                return

    def _check_epoch(self, epoch: Optional[int]) -> None:
        if epoch is not None and self._worker_epoch != epoch:
            raise _WorkerSuperseded()

    def _process(self, batch: List[_Request], epoch: Optional[int] = None) -> None:
        if self._fused:
            try:
                self._process_fused(batch, epoch)
                return
            except _FusedUnsupported as exc:
                self._fused_error = exc  # kept for diagnosis (what the capture raised)
            # A kernel failure is ambiguous: the metric's update may not be capturable
            # (demote permanently), or ONE malformed request may have poisoned its
            # chunk (reject that request, keep the fused path for everyone else). The
            # eager retry distinguishes them: it re-runs the same updates outside any
            # capture, so a malformed request fails ITS future there while an
            # uncapturable-but-valid update succeeds for every request.
            remaining = [req for req in batch if not req.future.done()]
            self._process_eager(remaining, epoch)
            if remaining and all(req.future.exception() is None for req in remaining):
                self._demote_to_eager()
            return
        self._process_eager([req for req in batch if not req.future.done()], epoch)

    # ---------------------------------------------------- fused (bucketed) dispatch

    def _process_fused(self, batch: List[_Request], epoch: Optional[int] = None) -> None:
        with self._dispatch_lock, self._on_stream():
            # re-validated under the lock a hang takeover must take before it
            # applies anything: a superseded worker never replays
            self._check_epoch(epoch)
            if self._tier is not None:
                # a request's slot was resolved at submit, outside this lock: the
                # tenant may have been demoted since (slot freed, maybe reused) or
                # was non-resident to begin with (slot None). Re-resolve each
                # slot, promoting non-resident tenants into their rows right
                # before the micro-batch that reads them. The lower tiers are
                # checked before the slot table: a submit racing a demotion can
                # allocate a fresh row for a key whose state sits in the warm
                # mirror, and the promotion restores that state over it.
                tier = self._tier
                warm, cold = tier.warm, tier.cold
                keyed = self._keyed
                slots = keyed._slots if isinstance(keyed, KeyedState) else None
                heat = tier._heat if self._tier_policy else None
                clock = tier.cfg.clock
                for req in batch:
                    if req.future.done():
                        continue
                    key = req.key
                    if key in warm or key in cold:
                        req.slot = self._promote_tenant(key)
                    elif slots is not None:
                        slot = slots.get(key)
                        req.slot = slot if slot is not None else keyed.slot_for(key)
                    else:
                        req.slot = keyed.slot_for(key)
                    if heat is not None:
                        heat[key] = clock()
            self._grow()
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
        if (self._guard is not None and (signature, bucket, self._keyed.capacity) not in self._kernels
                and not self._guard.allow_compile()):
            # capture breaker open: a novel signature would grow the graph cache —
            # run this chunk eagerly on the engine's device instead. Captured
            # graphs keep serving everyone else; the signature sprayer pays with
            # its own latency.
            self._apply_chunk_eager(units)
            return
        kernel = self._get_kernel(signature, bucket, self._keyed.capacity)
        columns, key_ids, mask, host = pad_micro_batch(
            [(req.slot, chunk_args, rows) for req, chunk_args, rows, _ in units], bucket, self._device
        )
        with _obs.engine_span("engine.dispatch", bucket=bucket, rows=total_rows):
            kernel(self._keyed, key_ids, mask, columns)
            # commit before completing futures: surfaces device-side errors here and
            # makes the receipt mean "your rows are in the state", not "enqueued"
            self._sync()
        # WAL after commit, before acks, from the host arrays (no read of the card):
        # an acknowledged chunk is always replayable, and a chunk whose capture
        # failed is never journaled (its eager retry journals per request)
        if self._journal is not None:
            traced: List[_TraceContext] = []
            if _OBS.enabled:
                # deduped: a request split into several row-chunks packed into one
                # micro-batch is linked once
                seen: set = set()
                for req, _, _, _ in units:
                    if req.ctx is not None and req.ctx.span_id not in seen:
                        seen.add(req.ctx.span_id)
                        traced.append(req.ctx)
            self._journal_chunk(units, *host, traced)
        self.telemetry.observe_batch(total_rows, bucket)
        now = time.perf_counter()
        for req, _, rows, is_last in units:
            req.rows_done += rows
            if not is_last:
                continue
            self.telemetry.count("processed")
            self.telemetry.observe_latency(now - req.t_submit)
            req.future.set_result({"key": req.key, "rows": req.rows, "bucket": bucket})
            if self._guard is not None and self._guard._quarantine_entries:
                # successes only matter to tenants with a live failure ledger
                self._guard.on_request_outcome(req.key, True)

    def _apply_chunk_eager(self, units: List[Tuple[_Request, Tuple[Any, ...], int, bool]]) -> None:
        """Apply one chunk's rows eagerly (capture breaker open; caller holds the
        dispatch lock, on the engine's stream): one whole-chunk ``update_state``
        per request on the engine's device, the eager path's semantics, journaled
        the same way (one ``R`` record per chunk unit) so a replay reproduces
        exactly what was applied."""
        for req, chunk_args, rows, is_last in units:
            if req.future.done():
                continue  # an earlier chunk of this request already failed it
            try:
                if self._journal is not None:
                    self._journal_append([_encode_request_record(self._key_bytes(req.key), chunk_args, req.ctx)])
                self._grow()
                args = tuple(as_request_tensor(a, self._device) for a in chunk_args)
                state = self._keyed.state_of(req.key)
                self._keyed.set_state(req.key, self._metric.update_state(state, *args))
                self._sync()
            except Exception as exc:  # noqa: BLE001 — fail THIS request, keep serving
                self.telemetry.count("failed")
                req.future.set_exception(exc)
                if self._guard is not None:
                    self._guard.on_request_outcome(req.key, False)
                continue
            req.rows_done += rows
            if not is_last:
                continue
            self.telemetry.count("processed")
            self.telemetry.observe_latency(time.perf_counter() - req.t_submit)
            req.future.set_result({"key": req.key, "rows": req.rows, "bucket": None})
            if self._guard is not None:
                self._guard.on_request_outcome(req.key, True)

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
        return _GraphKernel(self._metric.update_state, self._stream, self._graph_pool, self._hang_detector)

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

    def _process_eager(self, batch: List[_Request], epoch: Optional[int] = None) -> None:
        for req in batch:
            self._check_epoch(epoch)
            self._apply_inline(req)

    def _apply_inline(self, req: _Request) -> None:
        """Synchronous per-request dispatch (eager mode, and the degraded path).

        Applies only the rows a fused chunk has not already committed, so a request
        caught mid-demotion is never double-counted; the skip check and the
        applied marker both sit under the dispatch lock, so two appliers (a hang
        takeover and the superseded worker) serialize. Runs on the engine's device
        and stream whatever thread calls it (the watchdog's, in a takeover).
        """
        try:
            args = req.args if req.rows_done == 0 else tuple(a[req.rows_done :] for a in req.args)
            with _obs.engine_span("engine.inline", rows=req.rows), self._dispatch_lock, self._on_stream():
                if req.future.done() or (req.rows > 0 and req.rows_done >= req.rows):
                    return
                if self._tier is not None:
                    # readmit a non-resident tenant before touching its state;
                    # journaled (P) before the request record below, so replay
                    # restores then applies in the same order
                    self._resolve_slot(req.key)
                    if self._tier_policy:
                        self._tier.touch(req.key)
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
            if self._guard is not None:
                self._guard.on_request_outcome(req.key, False)
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
        if self._guard is not None and self._guard._quarantine_entries:
            self._guard.on_request_outcome(req.key, True)

    def _on_worker_death(self, exc: BaseException, batch: List[_Request], epoch: Optional[int] = None) -> None:
        """Dispatcher crashed: complete all accepted work inline, then degrade.

        ``_inflight`` stays equal to the unreplayed remainder throughout, so a
        concurrent ``flush()`` keeps blocking until the replay finishes — 'accepted
        implies committed after flush' holds across the degradation. With a guard
        plane configured for restarts, a fresh dispatcher starts once the replay
        completes and the engine returns to ``SERVING``.
        """
        self._worker_error = exc
        self.telemetry.count("worker_deaths")
        with self._lock:
            if epoch is not None and self._worker_epoch != epoch:
                return  # a hang takeover already owns this batch and the queue
            # supersede ourselves so a concurrent hang takeover cannot double-own
            self._worker_epoch += 1
            self._degraded = True
            self._active_batch = None
            pending = [req for req in batch if not req.future.done()] + self._queue
            if self._guard is not None:
                pending += self._guard.take_backlog()
            self._queue = []
            self._inflight = len(pending)
            self.telemetry.gauge_queue_depth(0)
            self._not_full.notify_all()
        self._apply_taken_over(pending)
        self._maybe_restart_worker()
        self._publish_health()

    def _apply_taken_over(self, pending: List[_Request]) -> None:
        """Apply a death or hang takeover's requests inline, keeping
        ``_inflight`` equal to what is left."""
        try:
            for req in pending:
                self._apply_inline(req)
                with self._lock:
                    self._inflight -= 1
        finally:
            with self._lock:
                self._inflight = 0
                self._idle.notify_all()
            if self._hang_detector is not None:
                self._hang_detector.mark_idle()

    def _on_worker_hang(self) -> None:
        """Watchdog callback: the dispatcher has been busy on one batch past the
        timeout. Supersede it (epoch bump) and decide by probing the dispatch lock:

        - taken within ``hang_lock_timeout_s`` → the worker is stuck *outside*
          the device path, and can never dispatch again (it re-checks its epoch
          under this very lock). Apply the taken-over batch and queue inline on
          the engine's stream, then restart a fresh dispatcher if configured.
        - not taken → the worker holds it inside a device call (a graph replay
          cannot be interrupted); applying the requests again would risk a
          double commit if that call ever completes. QUARANTINE the engine: fail
          every pending future fast and refuse all further calls.
        """
        guard = self._guard
        with self._lock:
            if self._closed or self._degraded or self._quarantined:
                return
            if self._active_batch is None and not self._queue and not guard.backlog.count:
                return  # raced with the batch's completion: nothing is stuck
            self._worker_epoch += 1
            self._degraded = True  # submits go inline while this is sorted out
            batch = self._active_batch or []
            self._active_batch = None
            pending = [req for req in batch if not req.future.done()] + self._queue
            pending += guard.take_backlog()
            self._queue = []
            self._inflight = len(pending)
            self.telemetry.gauge_queue_depth(0)
            self._not_full.notify_all()
        self.telemetry.count("worker_hangs")
        self._worker_error = TimeoutError(
            f"dispatcher hung: busy past the {guard.cfg.watchdog_timeout_s}s watchdog timeout"
        )
        if not self._dispatch_lock.acquire(timeout=guard.cfg.hang_lock_timeout_s):
            self._quarantine_engine(pending)
            return
        self._dispatch_lock.release()
        self._apply_taken_over(pending)
        self._maybe_restart_worker()
        self._publish_health()

    def _quarantine_engine(self, pending: List[_Request]) -> None:
        """The wedged worker cannot be taken over safely: fail fast from now on."""
        with self._lock:
            self._quarantined = True
            self._not_full.notify_all()
        exc = EngineQuarantined("StreamingEngine quarantined: dispatcher wedged in a device call; "
                                "request not committed")
        for req in pending:
            if not req.future.done():
                self.telemetry.count("failed")
                req.future.set_exception(exc)
            if req.is_probe and self._guard is not None:
                self._guard.abandon_probe(req.key)
        with self._lock:
            self._inflight = 0
            self._idle.notify_all()
        if self._hang_detector is not None:
            self._hang_detector.mark_idle()
        self._publish_health()

    def _maybe_restart_worker(self) -> None:
        """Start a fresh dispatcher after a death or hang takeover, budget permitting."""
        guard = self._guard
        if guard is None or not guard.cfg.restart:
            return
        with self._lock:
            if self._closed or self._quarantined:
                return
            if self._worker_restarts >= guard.cfg.max_restarts:
                return  # stay degraded-inline: restart storms help nobody
            self._worker_restarts += 1
            self._degraded = False
            self._spawn_worker()
        self.telemetry.count("watchdog_restarts")
        _obs.record_guard_event(guard._engine_label, "watchdog_restarts")

    # ---------------------------------------------------- tier plane

    def _ensure_tier(self) -> TierManager:
        """The residency manager — made lazily when replayed residency records or
        a tiered snapshot reach an engine built without ``tier=``. A lazy manager
        is mechanics only (demoted state stays readmittable); the eviction pass
        never runs without a configured policy."""
        if self._tier is None:
            self._tier = TierManager(TierConfig(), self._metric)
            self._tier_policy = False
        return self._tier

    def _resolve_slot(self, key: Hashable) -> Optional[int]:
        """Slot for ``key``, promoting it first if it lives in a lower tier
        (caller holds the dispatch lock, on the engine's stream)."""
        tier = self._tier
        if tier is not None and tier.has(key):
            return self._promote_tenant(key)
        return self._keyed.slot_for(key)

    def _promote_tenant(self, key: Hashable) -> Optional[int]:
        """Readmit one non-resident tenant into the slab (dispatch lock held, on
        the engine's stream): the entry is written into the slot's existing row
        in place, so every captured graph still reads it.

        A cold tenant's spill file is read back through the MTCKPT1 container
        (bit-identical), and deleted only AFTER the promote record, which embeds
        the entry, is journaled: a recovery never dereferences a dead file."""
        tier = self._tier
        src = tier.tier_of(key)
        with _obs.engine_span("engine.tier_promote", source=src or HOT):
            entry, _ = tier.pop_entry(key)
            keyed = self._keyed
            slot = keyed.slot_for(key)
            self._grow()
            spill = entry.pop("_spill_file", None) if entry is not None else None
            if self._journal is not None:
                blob = b"" if entry is None else ckpt_format.dumps(entry, meta={"kind": "tier-promote"})
                self._journal_append([_encode_tier_record(b"P", int(slot or 0), self._key_bytes(key), blob)])
                if slot is not None:
                    self._wal_slots_sent.add(slot)
            if entry is not None:
                restore_entry(keyed, key, entry)
            if spill is not None and tier.store is not None:
                tier.store.delete(spill)
        self.telemetry.count("tier_promotions")
        _obs.record_tier_promotion(self.telemetry.engine_id, src or "unknown")
        return slot

    def _demote_tenant(self, key: Hashable) -> bool:
        """Demote one hot tenant to the warm mirror (dispatch lock held, on the
        engine's stream).

        Capture → journal → evict → release: the demote record lands before the
        slot becomes reusable, so replay reproduces retire-then-reuse in commit
        order and a recovered engine never aliases the freed row."""
        if not self._is_resident(key):
            return False
        self._demote_many([key], [capture_entry(self._keyed, key)])
        return True

    def _demote_tenants(self, keys: Sequence[Hashable]) -> int:
        """Demote many hot tenants at once (dispatch lock held, on the engine's
        stream): their rows leave the card in one gather and one copy per leaf
        (:func:`~metrics_tpu_torch.tier.capture_entries`), are scrubbed in one
        pass per leaf, and the entries, the ``D`` records and the free-list end
        as one :meth:`_demote_tenant` call per key would leave them."""
        keys = [key for key in keys if self._is_resident(key)]
        if keys:
            self._demote_many(keys, capture_entries(self._keyed, keys))
        return len(keys)

    def _demote_many(self, keys: List[Hashable], entries: List[Dict[str, Any]]) -> None:
        keyed, tier = self._keyed, self._tier
        with _obs.engine_span("engine.tier_demote", tenants=len(keys)):
            if self._journal is not None:
                slot_of = keyed._slots if isinstance(keyed, KeyedState) else {}
                self._journal_append([_encode_tier_record(b"D", int(slot_of.get(key, 0)), self._key_bytes(key))
                                      for key in keys])
            if isinstance(keyed, KeyedState):
                slots = keyed.evict_many(keys)
                keyed.release_slots(slots)
            else:
                slots = [keyed.evict(key) for key in keys]
            for key, entry, slot in zip(keys, entries, slots):
                if slot is not None:
                    self._wal_slots_sent.discard(slot)
                tier.warm[key] = entry
                tier.forget_heat(key)
        self.telemetry.count("tier_demotions", len(keys))
        for _ in keys:
            _obs.record_tier_demotion(self.telemetry.engine_id)

    def _maybe_tier(self) -> None:
        """The between-batches eviction pass (dispatcher thread, like
        ``_maybe_checkpoint``): demote the coldest hot tenants down to
        ``hot_capacity`` (quarantined first, pinned never), then push the warm
        overflow to disk. Spill IO runs OFF the dispatch lock — only the manifest
        flip retakes it — so promotions never queue behind a disk write."""
        tier = self._tier
        if tier is None or not self._tier_policy:
            return
        keyed = self._keyed
        hot_count = len(keyed._slots) if isinstance(keyed, KeyedState) else len(keyed._states)
        if not tier.due(hot_count):
            return
        guard = self._guard
        quarantined = set(guard.quarantine.active()) if guard is not None else set()
        with self._dispatch_lock, self._on_stream():
            hot_keys = keyed.keys
            victims = tier.victims(hot_keys, len(hot_keys) - tier.cfg.hot_capacity, quarantined)
            if victims:
                self._demote_tenants(victims)
                self._sync()
        store = tier.store
        if store is not None:
            for key in tier.spill_victims():
                with self._dispatch_lock:
                    entry = tier.warm.get(key)
                if entry is None:
                    continue  # promoted between passes
                try:
                    name, blob = store.spill(key, entry)
                except Exception:  # noqa: BLE001 — disk trouble: stay warm, stay serving
                    self.telemetry.count("tier_spill_failures")
                    break
                with self._dispatch_lock:
                    flipped = tier.warm.get(key) is entry
                    if flipped:
                        del tier.warm[key]
                        tier.cold[key] = name
                if not flipped:
                    store.delete(name)  # promoted while we wrote: an orphaned file
                    continue
                self.telemetry.count("tier_spills")
                _obs.record_tier_spill(self.telemetry.engine_id, len(blob))
        self._publish_tier_gauges()

    def _publish_tier_gauges(self) -> None:
        if not _OBS.enabled:
            return
        eid = self.telemetry.engine_id
        tier = self._tier
        if tier is not None:
            keyed = self._keyed
            hot = len(keyed._slots) if isinstance(keyed, KeyedState) else len(keyed._states)
            _obs.set_tier_residency(eid, hot, len(tier.warm), len(tier.cold))
        shard = self.telemetry.label("shard")
        for dtype, nbytes in self._slab_bytes().items():
            _obs.set_engine_slab_bytes(eid, dtype, nbytes, shard=shard)

    def _require_tier(self, op: str) -> TierManager:
        if self._tier is None:
            raise MetricsTPUUserError(f"{op}() requires the engine to be built with tier=TierConfig(...)")
        return self._tier

    def register_tenants(self, keys: Sequence[Hashable]) -> int:
        """Register tenants as COLD residents — one manifest entry each, no slab
        growth, no spill file: a registered-but-silent tenant costs nothing on
        the device until its first submit promotes it. Returns how many keys
        were newly registered (known keys, hot or tiered, are left alone)."""
        tier = self._require_tier("register_tenants")
        self._check_writable("register_tenants")
        keyed = self._keyed
        table = keyed._slots if isinstance(keyed, KeyedState) else keyed._states
        added = 0
        with self._dispatch_lock:
            for key in keys:
                if key in table:
                    continue
                if tier.register_cold(key):
                    added += 1
        return added

    def pin_tenant(self, key: Hashable) -> None:
        """Exempt ``key`` from tier eviction; a non-resident pinned tenant is
        promoted at once (pinning promises slab residency)."""
        tier = self._require_tier("pin_tenant")
        self._check_writable("pin_tenant")
        with self._dispatch_lock, self._on_stream():
            tier.pinned.add(key)
            if not self._is_resident(key) and tier.has(key):
                self._promote_tenant(key)
                self._sync()

    def unpin_tenant(self, key: Hashable) -> None:
        if self._tier is not None:
            with self._dispatch_lock:
                self._tier.pinned.discard(key)

    def demote_tenant(self, key: Hashable) -> bool:
        """Demote one tenant to the warm mirror now (an operations hook; flushes
        first). Returns False if the key is unknown, pinned or already
        non-resident."""
        tier = self._require_tier("demote_tenant")
        self._check_quarantined("demote_tenant")
        self._check_writable("demote_tenant")
        self.flush()
        with self._dispatch_lock, self._on_stream():
            if key in tier.pinned:
                return False
            demoted = self._demote_tenant(key)
            self._sync()
        return demoted

    def tenant_tier(self, key: Hashable) -> Optional[str]:
        """Which tier ``key`` occupies: "hot", "warm" or "cold"; ``None`` for an
        unknown tenant."""
        with self._dispatch_lock:
            if self._is_resident(key):
                return HOT
            return self._tier.tier_of(key) if self._tier is not None else None

    def tier_stats(self) -> Dict[str, Any]:
        """Residency counts and the device slab's footprint, one plain dict."""
        with self._dispatch_lock:
            keyed = self._keyed
            hot = len(keyed._slots) if isinstance(keyed, KeyedState) else len(keyed._states)
            out: Dict[str, Any] = {"hot": hot, "warm": 0, "cold": 0, "pinned": 0,
                                   "slab_bytes": sum(self._slab_bytes().values())}
            tier = self._tier
            if tier is not None:
                out["warm"] = len(tier.warm)
                out["cold"] = len(tier.cold)
                out["pinned"] = len(tier.pinned)
                if self._tier_policy:
                    out["hot_capacity"] = tier.cfg.hot_capacity
        return out

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
        if self._guard is not None and self._guard.ckpt_breaker is not None:
            self._guard.ckpt_breaker.record_success()
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
        """Writer-thread callback: count the absorbed failure, feed the breaker."""
        self.telemetry.count("checkpoint_failures")
        if self._guard is not None and self._guard.ckpt_breaker is not None:
            self._guard.ckpt_breaker.record_failure()

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
            if self._shipper is not None:
                # shipping from a dead journal would heartbeat a frozen seq: the
                # follower would read fresh while the primary diverges
                self._shipper.mark_journal_lost()
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
        ctxs: Sequence[_TraceContext] = (),
    ) -> None:
        """Journal one committed fused micro-batch as a single chunk record, from
        the host arrays ``pad_micro_batch`` built it from, with the trace contexts
        of the requests it coalesced in its trailer.

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
        self._journal_append([_encode_chunk_record(new_slots, key_ids, mask, columns, ctxs)])

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
            _encode_request_record(
                self._key_bytes(req.key), req.args if args_override is None else args_override, req.ctx
            )
            for req in todo
        ]
        seqs = self._journal_append(payloads)
        if seqs is not None:
            for req, seq in zip(todo, seqs):
                req.seq = seq

    def _checkpoint_view(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Consistent host-side snapshot tree of ALL tenant state + WAL position.

        The slab is overwritten in place by every replay, so the copy to the host
        is taken under the dispatch lock on the engine's stream (after every replay
        enqueued before it), and the writer thread gets numpy arrays only, never
        tensors. The tree is the JAX package's.
        """
        with self._dispatch_lock, self._on_stream():
            keyed = self._keyed
            tree: Dict[str, Any] = {"kind": "engine", "seq": int(self._wal_seq)}
            tree["rotations"] = int(keyed.rotations)
            if self._tier is not None:
                tree["tier"] = self._tier.snapshot_view()
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
        tenants = len(keyed.keys)
        if self._tier is not None:
            tenants += len(self._tier.warm) + len(self._tier.cold)
        meta = {"tenants": tenants, "seq": tree["seq"]}
        if self._repl_cfg is not None:
            # the lineage's fencing token: a recovered promoted node knows which
            # epoch it owns without re-walking the promotion
            meta["epoch"] = self._repl_epoch
        return tree, meta

    def _maybe_checkpoint(self) -> None:
        if self._ckpt_writer is None:
            return
        breaker = self._guard.ckpt_breaker if self._guard is not None else None
        if breaker is not None:
            if not breaker.permit():
                # repeated commit failures: suspend snapshot attempts for the
                # (exponentially growing) probation; the WAL covers the gap
                self.telemetry.count("ckpt_suspended")
                return
            issued = False
            try:
                issued = self._ckpt_writer.maybe_checkpoint(self._checkpoint_view)
            except Exception:  # noqa: BLE001 — a snapshot failure must not kill the dispatcher
                self.telemetry.count("checkpoint_failures")
                breaker.record_failure()
                return
            finally:
                if not issued:
                    # nothing was attempted (not due, writer busy): a permitted
                    # half-open probe must not stay claimed forever
                    breaker.abandon_probe()
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
        generation is skipped) where it does not fit this engine's metric."""
        tree = snap.tree
        if snap.schema_version != _ENGINE_SCHEMA_VERSION:
            raise ValueError(f"engine snapshot schema v{snap.schema_version} != v{_ENGINE_SCHEMA_VERSION}")
        if not isinstance(tree, dict) or tree.get("kind") != "engine":
            raise ValueError("not an engine snapshot")
        tier_view = tree.get("tier")
        if tier_view is not None and not isinstance(tier_view, dict):
            raise ValueError("engine snapshot tier section is not a mapping")
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
        fused engine up front — recovering slower beats refusing to recover. A
        ``tier`` section restores the residency map; a snapshot without one
        clears any stale local map."""
        self._restore_slab(tree)
        view = tree.get("tier")
        if view:
            self._ensure_tier().restore_view(view)
        elif self._tier is not None:
            self._tier.restore_view({})

    def _restore_slab(self, tree: Dict[str, Any]) -> None:
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
        assignment order). The record's arrays reach the card through pinned,
        non-blocking copies, so a replay holds the dispatch lock for its enqueue
        only. A demoted/eager engine — or a chunk whose update cannot be captured
        here — falls back to the per-row walk, which is the same scan semantics,
        only slower.
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
            self._grow(min_slots=int(key_ids.max()) + 1 if len(key_ids) else 0)
            try:
                kernel = self._get_kernel(self._chunk_signature(columns), int(len(key_ids)), keyed.capacity)
                kernel(keyed, _to_device_async(key_ids, dev), _to_device_async(mask, dev),
                       [_to_device_async(c, dev) for c in columns])
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

    def _replay_request(self, key: Hashable, args: Tuple[np.ndarray, ...],
                        ctx: Optional[_TraceContext] = None) -> None:
        """Re-apply one 'R' record as ONE whole-request update — exactly how the
        eager/inline paths that produce these records applied it, so float
        accumulation rounds as it did in the lost process."""
        args = tuple(as_request_tensor(a, self._device) for a in args)
        keyed = self._keyed
        tier = self._tier
        if tier is not None and not self._is_resident(key) and tier.has(key):
            # defensive: a live engine journals a P record before any R for a
            # non-resident tenant, but an older snapshot's tier section can
            # still mark the key non-resident at this point of the replay
            entry, _ = tier.pop_entry(key)
            keyed.slot_for(key)
            self._grow()
            if entry is not None:
                restore_entry(keyed, key, entry)
        keyed.slot_for(key)
        if isinstance(keyed, EagerKeyedState):
            keyed.update(key, *args)
        else:
            self._grow()
            keyed.set_state(key, self._metric.update_state(keyed.state_of(key), *args))

    def _replay_demote(self, payload: bytes) -> None:
        """Replay one b"D" record: capture the tenant's row from the REPLAYED slab
        (bit-identical to what the journaling engine captured, because replay is
        bit-identical up to this record), park it warm, free the slot. The live
        engine may have spilled the entry since — content is what matters; tier
        placement is local policy."""
        _, key, _ = _decode_tier_record(payload)
        if not self._is_resident(key):
            return  # the snapshot already reflects the demotion
        tier = self._ensure_tier()
        entry = capture_entry(self._keyed, key)
        slot = self._keyed.evict(key)
        self._keyed.release_slot(slot)
        if slot is not None:
            self._replay_slot_keys.pop(slot, None)
            self._wal_slots_sent.discard(slot)
        tier.warm[key] = entry
        tier.forget_heat(key)

    def _replay_retire(self, payload: bytes) -> None:
        """Replay one b"T" record: forget the tenant in every tier, free its slot."""
        _, key, _ = _decode_tier_record(payload)
        if self._tier is not None:
            self._tier.discard(key)
            self._tier.forget_heat(key)
        if self._is_resident(key):
            slot = self._keyed.evict(key)
            self._keyed.release_slot(slot)
            if slot is not None:
                self._replay_slot_keys.pop(slot, None)
                self._wal_slots_sent.discard(slot)

    def _replay_promote(self, payload: bytes) -> None:
        """Replay one b"P" record: install the journaling engine's slot id and
        restore the embedded entry blob through the MTCKPT1 path — never the
        spill file, which the live engine deleted once this record was durable."""
        slot, key, blob = _decode_tier_record(payload)
        keyed = self._keyed
        if isinstance(keyed, KeyedState):
            keyed.install_slot(key, slot)
            self._replay_slot_keys[slot] = key
            self._grow(min_slots=slot + 1)
        else:
            keyed.slot_for(key)
        if blob:
            restore_entry(keyed, key, ckpt_format.loads(blob).tree)
        if self._tier is not None:
            self._tier.discard(key)

    def _apply_wal_payload(self, payload: bytes) -> None:
        """Dispatch one WAL record to its replayer (caller holds the dispatch lock,
        on the engine's stream).

        With obs on, each replayed record runs inside an ``engine.replay`` span
        carrying the trace ids the submitting engine stamped into the record: a
        follower's apply and a crash recovery's replay both land here, so their
        spans name the original trace ids."""
        if _OBS.enabled:
            attrs: Dict[str, Any] = {"kind": payload[:1].decode("latin1")}
            traces = _record_trace_hexes(payload)
            if traces:
                attrs["traces"] = traces
            with _obs.engine_span("engine.replay", **attrs):
                self._apply_wal_payload_inner(payload)
            return
        self._apply_wal_payload_inner(payload)

    def _apply_wal_payload_inner(self, payload: bytes) -> None:
        kind = payload[:1]
        if kind == b"C":
            self._replay_chunk(payload)
        elif kind == b"R":
            self._replay_request(*_decode_request_record(payload))
        elif kind == b"Z":
            self._keyed.reset()
            if self._tier is not None:
                for name in self._tier.reset():
                    if self._tier.store is not None:
                        self._tier.store.delete(name)
        elif kind == b"W":
            self._keyed.rotate()
        elif kind == b"D":
            self._replay_demote(payload)
        elif kind == b"T":
            self._replay_retire(payload)
        elif kind == b"P":
            self._replay_promote(payload)
        else:
            raise ValueError(f"unknown WAL record kind {kind!r}")

    def _recover(self) -> None:
        """Restart path: newest valid snapshot + exactly-once WAL replay, on this
        engine's device. A record that failed when it was first accepted fails
        again and is counted (``failed``)."""
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
                    except Exception:  # noqa: BLE001 — it failed when first accepted too
                        self.telemetry.count("failed")
                    replayed += 1
                    self._wal_seq = max(self._wal_seq, seq)
                if replayed:
                    self.telemetry.count("replayed", replayed)
            self._drop_stale_graphs()
            self._sync()

    # ---------------------------------------------------- replication plane

    def _init_replication(self, cfg: ReplConfig) -> None:
        self._repl_cfg = cfg
        self._repl_epoch = int(cfg.epoch)
        if cfg.role == "primary":
            if self._journal is None:
                raise MetricsTPUUserError(
                    "replication role 'primary' requires checkpoint=CheckpointConfig(..., wal=True): "
                    "the shipper publishes the durable plane's snapshot + WAL lineage"
                )
            # recover the lineage's fencing token: a restarted promoted node must
            # resume at the epoch it owns (snapshot meta), or its own fence would
            # reject its shipments
            resumed = bool(self._ckpt_store.generations())
            for gen in reversed(self._ckpt_store.generations()):
                try:
                    self._repl_epoch = max(self._repl_epoch, int(self._ckpt_store.read_meta(gen).get("epoch", 0)))
                    break
                except Exception:  # noqa: BLE001 — corrupt meta: fall back a generation
                    continue
            if resumed or self._wal_seq > -1:
                # every resume starts a NEW lineage epoch: a restarted primary may
                # re-use seqs its dead incarnation already shipped (a WAL tail lost
                # before it reached the disk), and within one epoch a follower's
                # seq chain would drop them as duplicates. The bump makes followers
                # re-bootstrap from the restart snapshot; the pin snapshot persists
                # it, so two incarnations never share an epoch.
                self._repl_epoch += 1
                if self._ckpt_writer is not None:
                    self._ckpt_writer.checkpoint_sync(self._checkpoint_view)
            self._shipper = Shipper(
                cfg, store=self._ckpt_store, journal=self._journal, telemetry=self.telemetry,
                engine_label=self.telemetry.engine_id, epoch=self._repl_epoch,
            )
        else:
            self._repl_follower = True
            self._applier = ReplicaApplier(self, cfg, telemetry=self.telemetry, engine_label=self.telemetry.engine_id)

    def _repl_reset_state(self) -> None:
        """Applier callback: drop ALL replica state (a wiped or replaced primary
        restarted its seq numbering, so the old mirror is meaningless). The slab
        is scrubbed in place, keeping its capacity, so the captured graphs stay
        bound to live memory."""
        with self._dispatch_lock, self._on_stream():
            keyed = self._keyed
            if isinstance(keyed, KeyedState):
                keyed.restore(keyed.capacity, keyed._tiled(keyed.capacity), {})
            else:
                self._keyed = EagerKeyedState(self._metric, window=self._window)
            self._replay_slot_keys = {}
            if self._tier is not None:
                self._tier.restore_view({})
            self._sync()

    def _repl_restore_snapshot(self, data: bytes) -> int:
        """Applier callback: bootstrap or rebootstrap from one shipped snapshot
        through the restore path recovery uses (copied into the live slab in
        place); returns the WAL seq it covers."""
        snap = ckpt_format.loads(data)
        self._validate_engine_snapshot(snap)
        with self._dispatch_lock, self._on_stream():
            self._restore_keyed(snap.tree)
            if snap.tree["mode"] == "fused":
                # chunk records reference slot ids; mappings introduced before the
                # snapshot live in rotated-away segments
                self._replay_slot_keys = {slot: key for key, slot in snap.tree["slots"].items()}
            self._sync()
        return int(snap.tree.get("seq", -1))

    def _repl_apply_record(self, payload: bytes) -> None:
        """Applier callback: replay ONE shipped WAL record through the machinery
        recovery uses (the follower's own bucket graphs, on the engine's stream,
        whichever thread calls), so the follower equals the primary at every
        applied seq. A record that failed on the primary fails here too (counted,
        absorbed) and still advances the seq chain, as it did there."""
        try:
            with self._dispatch_lock, self._on_stream():
                self._apply_wal_payload(payload)
        except Exception:  # noqa: BLE001 — it failed when the primary first accepted it too
            self.telemetry.count("failed")

    def _repl_quiesce(self) -> None:
        """Applier callback, once per received frame batch and outside the
        dispatch lock: wait for the engine's stream, so a reader never inherits
        more than one batch of pending replays."""
        self._sync()

    def replica_lag(self) -> Optional[ReplicaLag]:
        """This follower's staleness (``None`` unless it is a follower):
        ``compute``/``compute_all``/``wal_watermark`` refuse beyond the configured
        ``max_staleness``, and ``health()["replication"]`` embeds it."""
        applier = self._applier
        if applier is None or not self._repl_follower:
            return None
        lag = applier.lag()
        _obs.set_repl_lag(self.telemetry.engine_id, lag.seqs_behind, lag.seconds_behind)
        return lag

    def _check_staleness(self) -> None:
        """Refuse a follower read beyond the configured staleness bound."""
        applier = self._applier
        if applier is None or not self._repl_follower:
            return
        cfg = self._repl_cfg
        if cfg.max_staleness_seqs is None and cfg.max_staleness_s is None:
            return
        if not applier.bootstrapped:
            self.telemetry.count("stale_read_refusals")
            raise StalenessExceeded(
                "read refused: replica has not bootstrapped from the primary yet (its staleness is unbounded)"
            )
        lag = applier.lag()
        if lag.exceeds(cfg.max_staleness_seqs, cfg.max_staleness_s):
            self.telemetry.count("stale_read_refusals")
            raise StalenessExceeded(
                f"read refused: replica lag ({lag.seqs_behind} seqs, {lag.seconds_behind:.3f}s) "
                f"exceeds max_staleness (seqs={cfg.max_staleness_seqs}, s={cfg.max_staleness_s})"
            )

    def promote(self, *, epoch: Optional[int] = None, ship: Optional[ReplConfig] = None) -> None:
        """Follower → primary hot failover.

        Drains the shipped tail (the promoted node serves exactly the acked
        prefix: the seq chain drops duplicates and parks on gaps), fences the
        transport at ``deposed epoch + 1`` (a zombie primary's late shipments are
        rejected at the transport boundary from that instant), re-opens this
        node's OWN durable lineage (``promote_checkpoint``) with a synchronous pin
        snapshot, and starts a dispatcher: the engine is writable when this
        returns. Idempotent; called explicitly or by
        :func:`~metrics_tpu_torch.repl.failover_hook` from a guard's
        ``on_health_transition``. With obs on, the steps are the spans
        ``repl.drain``, ``repl.fence`` and ``repl.pin`` inside ``repl.promote``.

        ``epoch`` overrides the fencing epoch (it must exceed the applied lineage
        epoch); ``ship`` is a ``role="primary"`` ReplConfig installed after the
        promotion, so the new primary ships its lineage at once.
        """
        cfg = self._repl_cfg
        if cfg is None or cfg.role != "follower":
            raise MetricsTPUUserError("promote() requires replication=ReplConfig(role='follower')")
        if ship is not None and ship.role != "primary":
            raise MetricsTPUUserError(f"promote(ship=...) must be a role='primary' ReplConfig, got role={ship.role!r}")
        with self._promote_lock, _obs.repl_span("repl.promote"):
            if not self._repl_follower:
                return  # already promoted (an explicit call raced the failover hook)
            applier = self._applier
            if applier is None:
                raise NotPromotableError(
                    "promote(): this node is a demoted, unattached follower — it has no "
                    "ship link to drain a lineage from; re-attach it (demote(follower_cfg)) "
                    "and retry once it bootstraps"
                )
            if not applier.bootstrapped:
                # fresh-init state pinned as the new lineage would replace every
                # tenant's history by zeros; retryable once a snapshot lands. An
                # EMPTY-bootstrap replica is promotable: its primary had no state.
                raise NotPromotableError(
                    "promote(): this follower never bootstrapped — promoting would pin "
                    "fresh-init state as the new durable lineage, losing all tenant "
                    "history; retry once a snapshot has been applied"
                )
            if epoch is not None and epoch <= applier.epoch:
                raise MetricsTPUUserError(
                    f"promote(epoch={epoch}): the fencing epoch must exceed the applied "
                    f"lineage epoch ({applier.epoch}) — a stale lease cannot depose its successor"
                )
            # 1. stop the poll thread, drain what was already shipped; park() is
            # the hard cutoff (a poll thread that outlived its join, inside a
            # capture, must never replay old-primary records into the new lineage)
            with _obs.repl_span("repl.drain"):
                applier.stop()
                applier.drain(cfg.drain_timeout_s)
                applier.park()
            # 2. fence: from this instant the old epoch is dead at the boundary
            with _obs.repl_span("repl.fence"):
                new_epoch = applier.epoch + 1 if epoch is None else int(epoch)
                cfg.transport.fence(new_epoch)
                with self._lock:
                    self._repl_epoch = new_epoch
                    self._repl_follower = False
            # 3. own lineage: fresh WAL numbering + a synchronous pin snapshot
            self._wal_seq = -1
            with _obs.repl_span("repl.pin"):
                try:
                    self._open_promoted_lineage(cfg)
                except Exception as exc:  # noqa: BLE001 — the role already flipped:
                    # serve WITHOUT durability rather than half-promoted (no
                    # dispatcher, every retry blocked by the idempotency guard)
                    self._ckpt_writer = None
                    self._journal = None
                    self._wal_seq = -1
                    warnings.warn(
                        f"promote(): opening the promote_checkpoint lineage failed "
                        f"({type(exc).__name__}: {exc}) — the promoted primary is serving "
                        "WITHOUT durability",
                        RuntimeWarning,
                        stacklevel=2,
                    )
            # 3b. re-ship the new lineage over the transport the caller wired
            if ship is not None:
                self._repl_cfg = ship
                if self._journal is not None:
                    self._shipper = Shipper(
                        ship, store=self._ckpt_store, journal=self._journal, telemetry=self.telemetry,
                        engine_label=self.telemetry.engine_id, epoch=self._repl_epoch,
                    )
                else:
                    warnings.warn(
                        "promote(ship=...): no WAL journal after promotion (missing or failed "
                        "promote_checkpoint lineage) — the promoted primary cannot ship to its followers",
                        RuntimeWarning,
                        stacklevel=2,
                    )
            # 4. writable
            self.start()
        self.telemetry.count("promotions")
        _obs.record_repl_promotion(self.telemetry.engine_id)
        self._publish_health()

    def _open_promoted_lineage(self, cfg: ReplConfig) -> None:
        """Promotion step 3: the node's OWN durable plane + pin snapshot."""
        if cfg.promote_checkpoint is None:
            warnings.warn(
                "promote(): no ReplConfig.promote_checkpoint lineage configured — the "
                "promoted primary is serving WITHOUT durability",
                RuntimeWarning,
                stacklevel=3,
            )
            return
        from dataclasses import replace as _dc_replace

        self._init_checkpoint(_dc_replace(cfg.promote_checkpoint, resume=False))
        if self._journal is not None:
            # a directory re-used by a node promoted before: its journal numbers on
            # past the leftover segments. Anchor at that tail, so the pin covers
            # every stale record and a recovery replays only this incarnation's
            self._wal_seq = int(self._journal.last_seq)
        self._ckpt_writer.checkpoint_sync(self._checkpoint_view)

    def demote(self, replication: Optional[ReplConfig] = None) -> None:
        """Primary → follower step-down, the mirror of :meth:`promote`.

        Refuses new writes first (:class:`~metrics_tpu_torch.repl.NotPrimaryError`
        from the instant the flag flips), drains accepted work into the old
        lineage, stops the dispatcher and the shipper (whose close makes one
        final publish), releases the durable plane (a follower owns no lineage),
        then attaches the new follow link (``replication``, a ``role="follower"``
        ReplConfig) or parks read-only and unattached (``None``). On a follower
        only the link swap runs. The old transport is not fenced here: fencing
        belongs to the successor's promotion.
        """
        if replication is not None and replication.role != "follower":
            raise MetricsTPUUserError(
                f"demote() takes replication=None or a role='follower' ReplConfig, got role={replication.role!r}"
            )
        with self._promote_lock:
            with self._lock:
                self._repl_follower = True
                self._not_empty.notify_all()
            drain_s = (
                replication.drain_timeout_s
                if replication is not None
                else (self._repl_cfg.drain_timeout_s if self._repl_cfg is not None else 5.0)
            )
            worker = self._worker
            if worker is not None and not self._quarantined:
                try:
                    self.flush(timeout=drain_s)
                except TimeoutError:
                    warnings.warn(
                        f"demote(): drain did not complete within {drain_s}s — "
                        "unfinished accepted work is abandoned with the old lineage",
                        RuntimeWarning,
                        stacklevel=2,
                    )
            if worker is not None:
                with self._lock:
                    self._worker_epoch += 1
                    self._worker = None
                    self._not_empty.notify_all()
                if worker is not threading.current_thread():
                    worker.join(timeout=5.0)
            if self._shipper is not None:
                self._shipper.close()
                self._shipper = None
            if self._applier is not None:
                self._applier.stop()
                self._applier = None
            if self._ckpt_writer is not None:
                self._ckpt_writer.close()
                self._ckpt_writer = None
            if self._journal is not None:
                self._journal.close()
                self._journal = None
            self._ckpt_store = None
            self._ckpt_cfg = None
            self._wal_seq = -1
            self._wal_error = None
            self._wal_slots_sent = set()
            self._snapshot_seqs = {}
            if replication is not None:
                self._repl_cfg = replication
                self._applier = ReplicaApplier(
                    self, replication, telemetry=self.telemetry, engine_label=self.telemetry.engine_id
                )
        self.telemetry.count("demotions")
        self._publish_health()

    def _replication_health(self) -> Dict[str, Any]:
        info: Dict[str, Any] = {"role": "follower" if self._repl_follower else "primary", "epoch": self._repl_epoch}
        shipper, applier = self._shipper, self._applier
        if shipper is not None:
            info["shipped_seq"] = shipper.last_shipped_seq
            info["shipped_generation"] = shipper.shipped_generation
            info["fenced"] = shipper.fenced
            info["ship_failures"] = shipper.ship_failures
            # a spooling transport that hit its cap dropped frames a follower
            # must re-bootstrap past
            spool_dropped = getattr(shipper.transport, "spool_dropped", None)
            if spool_dropped is not None:
                info["spool_dropped"] = spool_dropped
            err = shipper.last_error
            info["ship_error"] = None if err is None else f"{type(err).__name__}: {err}"
        if applier is not None:
            info["applied_seq"] = applier.applied_seq
            info["known_seq"] = applier.known_seq
            info["bootstrapped"] = applier.bootstrapped
            err = applier.last_error
            info["apply_error"] = None if err is None else f"{type(err).__name__}: {err}"
            if self._repl_follower:
                lag = applier.lag()
                info["lag_seqs"] = lag.seqs_behind
                info["lag_seconds"] = lag.seconds_behind
        return info
