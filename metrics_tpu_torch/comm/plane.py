"""The comm plane: every state synchronisation in the port funnels through here
(port of ``metrics_tpu/comm/plane.py``).

``Metric._sync_dist``, ``parallel.sync.sync_state_host``, ``reduce_in_trace``
and the engine's ``compute(key, sync=True)`` all land on one of three entry
points:

- :func:`sync_pytree` — the planned, codec'd, fault-tolerant host path:
  plan (cached) → encode → coalesced/ragged collectives → decode → reduce.
- :func:`sync_with_gather_fn` — the leaf-at-a-time compatibility path for
  callers that inject a ``gather_fn``/``dist_sync_fn`` (the reference
  protocol); no codecs (an injected gather returns *decoded* peer tensors),
  same reduction semantics, same obs accounting.
- :func:`reduce_in_trace` — the device path: one ``torch.distributed``
  collective on the state's own device over ``axis_name``, with optional
  blockwise-quantized gather for ``cat``-style states.

What ``axis_name`` is here: the JAX package names mesh axes inside
``shard_map``; the port takes a ``torch.distributed.ProcessGroup``, or a
string or tuple of strings naming dimensions of the
``torch.distributed.device_mesh.DeviceMesh`` installed with
:func:`metrics_tpu_torch.comm.axis.use_mesh`. A tuple gathers in the
row-major order of the named dimensions, as ``lax.all_gather`` over several
mesh axes does.

Fault tolerance: each host collective runs under the configured deadline; a
failed attempt retries with bounded exponential backoff, then the sync
*degrades* down a ladder —

    full sync (policy codecs) → lossless-only → live-subset → local state + staleness flag

where **live-subset** (membership-capable transports only) runs the two-phase
live-set agreement from :mod:`metrics_tpu_torch.comm.membership`: every
survivor commits to the same agreed sub-world and the plan re-executes over
it — exact for cumulative mergeable state, so one dead host shrinks the
aggregate instead of shattering it into N local answers. Rejoin is automatic:
a returning rank's deposit is picked up by the next agreement round and the
following sync is full-world again. Every rung is visible in obs
(``metrics_tpu_torch_comm_retries_total``, ``_timeouts_total``,
``_degradations_total``, ``_partial_syncs_total``, ``_peer_live``,
``_stale_state``) and in the :class:`SyncReport` returned by
:func:`last_report`. Reduction order is deterministic across retries: the plan
fixes leaf order, ranks always reduce in rank order, and backoff jitter is
deterministic (rank-seeded decorrelation, no wall-clock randomness).

The host path stages a state that lives on the card through numpy, as the JAX
package's stages through ``multihost_utils``, and puts each synced leaf back
on the device that held it.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.comm import membership as _membership
from metrics_tpu_torch.comm.axis import resolve_axis
from metrics_tpu_torch.comm.codec import CodecPolicy, EncodedLeaf, get_codec
from metrics_tpu_torch.comm.membership import MembershipError, WorldView, view_for
from metrics_tpu_torch.comm.plan import TransferPlan, build_plan, device_tensor, host_array
from metrics_tpu_torch.comm.transport import (
    LocalTransport,
    MultihostTransport,
    PeerLostError,
    Transport,
    TransportError,
    TransportTimeout,
    gather_ragged,
    set_call_cancel_event,
)
from metrics_tpu_torch.obs import instrument as _obs
from metrics_tpu_torch.obs.registry import OBS as _OBS
from metrics_tpu_torch.utils.data import apply_to_collection, dim_zero_cat

__all__ = [
    "CommConfig",
    "SyncReport",
    "configure",
    "default_transport",
    "get_config",
    "last_report",
    "reduce_in_trace",
    "sync_pytree",
    "sync_with_gather_fn",
    "use_config",
]


# ----------------------------------------------------------------- configuration


@dataclass
class CommConfig:
    """Process-wide comm-plane knobs (see :func:`configure`).

    The default is deliberately conservative: lossless everywhere, coalesced,
    no deadline (a host gather blocks like it always did), degradation on.
    """

    policy: CodecPolicy = field(default_factory=CodecPolicy)
    chunk_bytes: int = 4 << 20
    coalesce: bool = True
    timeout_s: Optional[float] = None
    max_retries: int = 2
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    degrade: bool = True
    transport: Optional[Transport] = None
    # membership / live-subset rung: on membership-capable transports, a sync
    # that loses peers agrees on the surviving live set and completes over it
    # instead of falling to local state — as long as at least
    # max(2, min_quorum) ranks survive. membership_deadline_s bounds each
    # agreement phase (defaults to timeout_s, else 1s). The happy path pays
    # only attr-loads: no agreement round runs while the view is all-live.
    membership: bool = True
    min_quorum: int = 2
    membership_deadline_s: Optional[float] = None
    # observer hook: called with every published SyncReport (success, degraded
    # or stale) — how health machinery (the engine's comm circuit breaker,
    # metrics_tpu_torch.guard) watches sync outcomes without polling
    # last_report(). Exceptions are absorbed + rank_zero_warn'ed: observation
    # must never fail a sync.
    on_report: Optional[Callable[["SyncReport"], None]] = None


_CONFIG = CommConfig()
_CONFIG_LOCK = threading.Lock()


def get_config() -> CommConfig:
    with _CONFIG_LOCK:
        return _CONFIG


def configure(**kwargs: Any) -> CommConfig:
    """Replace fields of the process-wide :class:`CommConfig`; returns the
    previous config so callers can restore it."""
    global _CONFIG
    with _CONFIG_LOCK:
        prev = _CONFIG
        _CONFIG = replace(_CONFIG, **kwargs)
    return prev


class use_config:
    """Context manager: run a block under a temporary comm config."""

    def __init__(self, **kwargs: Any) -> None:
        self._kwargs = kwargs
        self._prev: Optional[CommConfig] = None

    def __enter__(self) -> CommConfig:
        self._prev = configure(**self._kwargs)
        return get_config()

    def __exit__(self, *exc: Any) -> None:
        global _CONFIG
        with _CONFIG_LOCK:
            _CONFIG = self._prev


def default_transport() -> Transport:
    """Multihost when ``torch.distributed`` is initialised with more than one
    rank, else the world-of-one identity."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return MultihostTransport()
    return LocalTransport()


# ----------------------------------------------------------------- sync reports


@dataclass
class SyncReport:
    """What one :func:`sync_pytree` call did — the non-obs view of the ladder."""

    site: str = "comm.sync"
    world: int = 1
    raw_bytes: int = 0
    wire_bytes: int = 0
    retries: int = 0
    timeouts: int = 0
    degraded_step: str = "none"  # none | lossless_only | live_subset | local_state
    stale: bool = False
    # membership outcome: which ranks the agreed live set excluded, and how
    # many ranks actually contributed state (== world on a full-world sync)
    peers_lost: Tuple[int, ...] = ()
    world_live: int = 0

    @property
    def world_size(self) -> int:
        return self.world

    @property
    def compression_ratio(self) -> float:
        return self.raw_bytes / self.wire_bytes if self.wire_bytes else 1.0


_LAST_REPORT: Optional[SyncReport] = None
_REPORT_LOCK = threading.Lock()


def last_report() -> Optional[SyncReport]:
    """The most recent :class:`SyncReport` (best-effort under concurrency)."""
    with _REPORT_LOCK:
        return _LAST_REPORT


def _publish(report: SyncReport, config: Optional[CommConfig] = None) -> None:
    global _LAST_REPORT
    with _REPORT_LOCK:
        _LAST_REPORT = report
    hook = config.on_report if config is not None else None
    if hook is not None:
        try:
            hook(report)
        except Exception as exc:  # noqa: BLE001 — observation must never fail a sync
            from metrics_tpu_torch.utils.prints import rank_zero_warn

            rank_zero_warn(
                f"comm on_report observer raised {type(exc).__name__}: {exc} — "
                "report absorbed; a buggy observer must not take the sync path down"
            )


# ----------------------------------------------------------------- transport wrappers


class _TimeoutTransport(Transport):
    """Run each collective under a deadline in a worker thread.

    The underlying call cannot be cancelled outright: a ``torch.distributed``
    collective has no abort, as a JAX ``multihost_utils`` one has none, so a
    timed-out call keeps running on its daemon thread until its peers arrive
    or the process group fails it. On timeout the worker is *abandoned safely*:

    - every call is stamped with a generation; a timeout bumps it, so a late
      completion can never publish its result into a later attempt's hands;
    - the worker's cooperative cancel event is set — in-process transports
      check it before touching shared barriers, so a late-running abandoned
      call cannot deposit into a fresh round;
    - the inner transport is ``reset()`` (when it supports it) so an abandoned
      waiter cannot keep occupying a barrier seat.

    One instance is shared across a sync's retries — that is what makes the
    generation stamp meaningful.
    """

    def __init__(self, inner: Transport, timeout_s: Optional[float]) -> None:
        self._inner = inner
        self._timeout_s = timeout_s
        self._gen = 0
        self._gen_lock = threading.Lock()

    @property
    def name(self) -> str:  # type: ignore[override]
        return self._inner.name

    @property
    def supports_broadcast(self) -> bool:  # type: ignore[override]
        return self._inner.supports_broadcast

    @property
    def rank(self) -> Any:
        return getattr(self._inner, "rank", None)

    def world_size(self) -> int:
        return self._inner.world_size()

    def _call(self, fn: Callable, *args: Any) -> Any:
        if not self._timeout_s:
            return fn(*args)
        with self._gen_lock:
            self._gen += 1
            gen = self._gen
        box: List[Any] = [None, None, False]
        done = threading.Event()
        cancel = threading.Event()

        def _run() -> None:
            set_call_cancel_event(cancel)
            try:
                out, exc = fn(*args), None
            except BaseException as e:  # noqa: BLE001 — re-raised below
                out, exc = None, e
            finally:
                set_call_cancel_event(None)
            with self._gen_lock:
                if self._gen == gen:
                    box[0], box[1], box[2] = out, exc, True
            done.set()

        t = threading.Thread(target=_run, daemon=True)
        t.start()
        done.wait(self._timeout_s)
        with self._gen_lock:
            landed = box[2]
            if not landed:
                self._gen += 1  # stamp the call abandoned before the worker can land
        if landed:
            if box[1] is not None:
                raise box[1]
            return box[0]
        cancel.set()
        reset = getattr(self._inner, "reset", None)
        if reset is not None:
            reset()
        raise TransportTimeout(f"collective exceeded {self._timeout_s}s deadline")

    def allgather(self, x: np.ndarray) -> List[np.ndarray]:
        return self._call(self._inner.allgather, x)

    def broadcast_from(self, x: Optional[np.ndarray], root: int, shape: Any, dtype: Any) -> np.ndarray:
        return self._call(self._inner.broadcast_from, x, root, shape, dtype)


class _MeteredTransport(Transport):
    """Counts the bytes this rank puts on the wire (sends only)."""

    def __init__(self, inner: Transport) -> None:
        self._inner = inner
        self.sent_bytes = 0

    @property
    def name(self) -> str:  # type: ignore[override]
        return self._inner.name

    @property
    def supports_broadcast(self) -> bool:  # type: ignore[override]
        return self._inner.supports_broadcast

    @property
    def rank(self) -> Any:
        return getattr(self._inner, "rank", None)

    def world_size(self) -> int:
        return self._inner.world_size()

    def allgather(self, x: np.ndarray) -> List[np.ndarray]:
        self.sent_bytes += int(np.asarray(x).nbytes)
        return self._inner.allgather(x)

    def broadcast_from(self, x: Optional[np.ndarray], root: int, shape: Any, dtype: Any) -> np.ndarray:
        if x is not None:
            self.sent_bytes += int(np.asarray(x).nbytes)
        return self._inner.broadcast_from(x, root, shape, dtype)


# ----------------------------------------------------------------- reductions

_REDUCIBLE_OPS = {"sum", "mean", "max", "min"}


def _leaf_device(val: Any) -> torch.device:
    """The device a synced leaf goes back to: its own, or the CPU for numpy
    leaves and Python scalars."""
    if isinstance(val, list) and val:
        val = val[0]
    return val.device if isinstance(val, Tensor) else torch.device("cpu")


def _sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """``jnp.sum``'s result dtype with x64 off: booleans and integers up to 32
    bits sum in int32 (``torch.sum`` would give int64), floats keep theirs."""
    if dtype == torch.bool or (not dtype.is_floating_point and not dtype.is_complex and dtype.itemsize <= 4):
        return torch.int32
    return dtype


def _reduce_stack(op: str, stacked: Tensor) -> Tensor:
    """``jnp.{sum,mean,max,min}(stacked, axis=0)`` with JAX's result dtypes."""
    if op == "sum":
        return torch.sum(stacked, dim=0, dtype=_sum_dtype(stacked.dtype))
    if op == "mean":
        # jnp.mean sums in float32 (ints included) and divides by the count
        out = torch.sum(stacked.to(torch.promote_types(stacked.dtype, torch.float32)), dim=0) / stacked.shape[0]
        return out.to(stacked.dtype) if stacked.dtype.is_floating_point else out
    if op == "max":
        return torch.amax(stacked, dim=0)
    return torch.amin(stacked, dim=0)


def _reduce_rows(tag: str, reduction: Any, rows: List[Any], is_list: bool, device: torch.device) -> Any:
    """Reduce rank-ordered rows with the pre-comm ``sync_state_host`` semantics."""
    rows_t = [device_tensor(r, device) for r in rows]
    if is_list:
        return [dim_zero_cat(rows_t)]
    if tag in _REDUCIBLE_OPS:
        return _reduce_stack(tag, torch.stack(rows_t))
    if tag == "cat":
        return torch.cat(rows_t, dim=0)
    if tag == "callable":
        return reduction(torch.stack(rows_t))
    # None: stack to (world, ...), matching reduce_in_trace's all_gather
    return torch.stack(rows_t)


# ----------------------------------------------------------------- planned execution


def _execute_plan(
    plan: TransferPlan,
    state: Dict[str, Any],
    reductions: Dict[str, Any],
    transport: Transport,
) -> Tuple[Dict[str, Any], int]:
    """One fault-free pass: encode → collectives → decode → reduce.

    Returns ``(synced_state, raw_bytes)``; wire bytes are metered on the
    transport by the caller. Raises ``TransportError``/``TransportTimeout``
    through from the transport — retry policy lives in :func:`sync_pytree`.
    """
    world = transport.world_size()
    encoded: Dict[str, EncodedLeaf] = {}
    raw_bytes = 0
    for lf in plan.leaves:
        if lf.route == "skip":
            continue
        val = state[lf.name]
        if lf.is_list:
            val = dim_zero_cat(val)
        enc = get_codec(lf.codec_name).encode(host_array(val))
        encoded[lf.name] = enc
        raw_bytes += enc.raw_nbytes

    # payload rows per (leaf, payload_idx), rank-ordered (lossy coalesced leaves)
    payload_rows: Dict[Tuple[str, int], List[np.ndarray]] = {}
    # leaves finished by the buffer-level fast path
    fast_done: Dict[str, Any] = {}

    # coalesced buffers: one flat array per (wire dtype, reduction op), chunked
    for buf in plan.buffers:
        flat = np.empty(buf.total, dtype=np.dtype(buf.dtype))
        for slot in buf.slots:
            flat[slot.offset : slot.offset + slot.size] = encoded[slot.leaf].payloads[slot.payload_idx].ravel()
        rank_parts: List[List[np.ndarray]] = [[] for _ in range(world)]
        for start, stop in buf.chunks:
            rows = transport.allgather(flat[start:stop])
            for r in range(world):
                row = np.asarray(rows[r]).ravel()
                if row.size != stop - start:
                    # the coalesced route is only sound when every rank holds
                    # identically-shaped leaves (true by construction for
                    # registered fixed-shape states). A custom callable-reduced
                    # state whose shape DIVERGES across ranks would otherwise
                    # be sliced with local offsets and reduced silently wrong —
                    # make it a loud transport failure instead.
                    raise TransportError(
                        f"coalesced sync: rank {r} gathered {row.size} elements for a "
                        f"{stop - start}-element chunk of buffer ({buf.dtype}, {buf.op}) — "
                        "a fixed-shape state's shape diverged across ranks (leaves "
                        f"{[s.leaf for s in buf.slots]})"
                    )
                rank_parts[r].append(row)
        rank_flats = [
            parts[0] if len(parts) == 1 else np.concatenate(parts) for parts in rank_parts
        ]
        if buf.fast:
            # all-lossless buffer: ONE device copy + ONE reduction for every
            # slotted leaf, then slice — bit-identical to per-leaf reduction
            # (axis-0 reduces are independent per element), ~W× fewer torch ops
            device = _leaf_device(state[buf.slots[0].leaf])
            reduced = _reduce_stack(buf.op, device_tensor(np.stack(rank_flats), device))
            for slot in buf.slots:
                fast_done[slot.leaf] = reduced[slot.offset : slot.offset + slot.size].reshape(slot.shape).to(
                    _leaf_device(state[slot.leaf])
                )
            continue
        for r, rank_flat in enumerate(rank_flats):
            for slot in buf.slots:
                payload_rows.setdefault((slot.leaf, slot.payload_idx), [None] * world)[r] = rank_flat[
                    slot.offset : slot.offset + slot.size
                ].reshape(slot.shape)

    # ragged leaves: per-leaf shape gather + per-payload ragged gather
    decoded_rows: Dict[str, List[np.ndarray]] = {}
    rank = getattr(transport, "rank", None)
    for lf in plan.leaves:
        if lf.route != "ragged":
            continue
        enc = encoded[lf.name]
        codec = get_codec(lf.codec_name)
        shape_rows = transport.allgather(np.asarray(enc.shape, dtype=np.int64))
        peer_shapes = [tuple(int(d) for d in s) for s in shape_rows]
        gathered_payloads = [
            gather_ragged(transport, np.asarray(p), rank=rank) for p in enc.payloads
        ]
        decoded_rows[lf.name] = [
            codec.decode(
                EncodedLeaf(
                    lf.codec_name,
                    tuple(gathered_payloads[i][r] for i in range(len(enc.payloads))),
                    peer_shapes[r],
                    np.dtype(lf.dtype),
                )
            )
            for r in range(world)
        ]

    # decode + reduce, in plan (== reduction-dict) order; rank order is fixed
    synced = dict(state)
    for lf in plan.leaves:
        if lf.route == "skip":
            continue
        if lf.name in fast_done:
            synced[lf.name] = fast_done[lf.name]
            continue
        codec = get_codec(lf.codec_name)
        if lf.route == "coalesce":
            nP = len(codec.payload_specs(lf.shape, np.dtype(lf.dtype)))
            rows = [
                codec.decode(
                    EncodedLeaf(
                        lf.codec_name,
                        tuple(payload_rows[(lf.name, i)][r] for i in range(nP)),
                        lf.shape,
                        np.dtype(lf.dtype),
                    )
                )
                for r in range(world)
            ]
        else:
            rows = decoded_rows[lf.name]
        reduction = reductions.get(lf.name, "sum")  # the trailing _update_count sums
        synced[lf.name] = _reduce_rows(lf.reduction_tag, reduction, rows, lf.is_list, _leaf_device(state[lf.name]))
    return synced, raw_bytes


def _plan_has_lossy(plan: TransferPlan) -> bool:
    return any(not get_codec(lf.codec_name).lossless for lf in plan.leaves if lf.route != "skip")


def _backoff_s(cfg: CommConfig, attempt: int, rank: int) -> float:
    """Deterministic rank-seeded decorrelated backoff jitter.

    N ranks that lost the same peer fail the same collective at the same
    instant; a jitter-free ladder would retry them in lockstep. Seeding the
    jitter from ``(rank, attempt)`` de-synchronises the retry storm while
    staying bit-reproducible in tests — no wall-clock randomness.
    """
    base = cfg.backoff_base_s * (2**attempt)
    rng = np.random.default_rng(int(rank + 1) * 1_000_003 + int(attempt))
    return float(min(cfg.backoff_max_s, base * (0.5 + rng.random())))


def _record_peer_liveness(view: WorldView) -> None:
    lost = set(view.lost())
    for peer in range(view.world):
        _obs.record_comm_peer_live(peer, peer not in lost)


def sync_pytree(
    state: Dict[str, Any],
    reductions: Dict[str, Any],
    *,
    transport: Optional[Transport] = None,
    config: Optional[CommConfig] = None,
    site: str = "comm.sync",
) -> Dict[str, Any]:
    """Host-level all-reduce of a functional state pytree through the comm plane.

    The planned path: cached transfer plan, per-leaf codecs, coalesced/chunked
    collectives, and the retry → degradation ladder documented on this module.
    Returns the synced state; inspect :func:`last_report` (or the obs comm
    counters) for what it took to get it.
    """
    cfg = config or get_config()
    tr = transport or cfg.transport or default_transport()
    world_full = tr.world_size()
    report = SyncReport(site=site, world=world_full)

    # membership engages only on capable transports with a real world — the
    # happy path's whole cost is these attr-loads plus one has_lost() check
    mview: Optional[WorldView] = None
    if cfg.membership and world_full > 1 and getattr(tr, "supports_membership", False):
        mview = view_for(tr)

    plan = build_plan(
        state, reductions, cfg.policy, chunk_bytes=cfg.chunk_bytes, coalesce=cfg.coalesce, world=world_full
    )
    steps: List[Tuple[str, CodecPolicy]] = [("full", cfg.policy)]
    if _plan_has_lossy(plan):
        steps.append(("lossless_only", cfg.policy.all_lossless()))

    rank = getattr(tr, "rank", None) or 0
    quorum = max(2, int(cfg.min_quorum))
    agree_deadline = cfg.membership_deadline_s or cfg.timeout_s or 1.0
    subset_recorded = False

    with _obs.comm_span("comm.sync", site=site, world=report.world):
        # bounded (agreement + execution) passes: a degraded episode's live set
        # can only shrink, so the ladder always terminates
        for _pass in range(world_full + cfg.max_retries + 2):
            agreed: Optional[Tuple[int, ...]] = None
            if mview is not None and mview.has_lost():
                # known-lost peers: agree BEFORE payload, so the sync never
                # stalls a full-world deadline on a peer it knows is gone —
                # and a rejoiner's board deposit gets picked up right here
                try:
                    agreed = _membership.agree_live_set(tr, mview, deadline_s=agree_deadline)
                except MembershipError:
                    break
                _record_peer_liveness(mview)
                if len(agreed) < quorum:
                    break
            subset_mode = agreed is not None and len(agreed) < world_full
            exec_tr: Transport = tr.subset(agreed) if subset_mode else tr  # type: ignore[attr-defined]
            if subset_mode and not subset_recorded:
                subset_recorded = True
                _obs.record_comm_degradation(site, "live_subset")
                _obs.record_comm_partial_sync(site)
            # the live_subset rung sits between lossless_only and local_state:
            # subset execution is lossless-only by construction
            pass_steps = [("live_subset", cfg.policy.all_lossless())] if subset_mode else steps
            # ONE deadline wrapper per pass: its generation stamp spans retries,
            # so an abandoned attempt's late completion is always discarded
            deadline_tr = _TimeoutTransport(exec_tr, cfg.timeout_s)
            failure: Optional[BaseException] = None
            for step_idx, (step_name, policy) in enumerate(pass_steps):
                step_plan = (
                    plan
                    if step_name == "full"
                    else build_plan(
                        state,
                        reductions,
                        policy,
                        chunk_bytes=cfg.chunk_bytes,
                        coalesce=cfg.coalesce,
                        world=exec_tr.world_size(),
                    )
                )
                for attempt in range(cfg.max_retries + 1):
                    metered = _MeteredTransport(deadline_tr)
                    try:
                        synced, raw = _execute_plan(step_plan, state, reductions, metered)
                    except PeerLostError as exc:
                        failure = exc
                        if mview is not None and exc.peers:
                            mview.mark_lost(exc.peers)
                            _record_peer_liveness(mview)
                        break  # membership broke: same-step retries cannot succeed
                    except TransportTimeout as exc:
                        failure = exc
                        report.timeouts += 1
                        _obs.record_comm_timeout(site)
                    except TransportError as exc:
                        failure = exc
                    else:
                        if subset_mode:
                            report.degraded_step = "live_subset"
                            report.peers_lost = tuple(r for r in range(world_full) if r not in agreed)
                            report.world_live = len(agreed)
                        else:
                            report.world_live = world_full
                            if agreed is not None:
                                report.degraded_step = "none"  # world fully restored
                        report.raw_bytes = raw
                        report.wire_bytes = metered.sent_bytes
                        _obs.record_comm_payload(site, raw, metered.sent_bytes)
                        _obs.set_comm_stale(site, False)
                        _publish(report, cfg)
                        return synced
                    if attempt < cfg.max_retries:
                        report.retries += 1
                        _obs.record_comm_retry(site)
                        time.sleep(_backoff_s(cfg, attempt, rank))
                if isinstance(failure, PeerLostError) and mview is not None:
                    break  # live_subset is the next rung: go re-agree
                if step_idx + 1 < len(pass_steps):
                    report.degraded_step = pass_steps[step_idx + 1][0]
                    _obs.record_comm_degradation(site, pass_steps[step_idx + 1][0])
            if mview is None or not mview.has_lost():
                break  # no membership signal to act on: the ladder is exhausted

    # ladder exhausted: serve local state, flagged stale
    if not cfg.degrade:
        _publish(report, cfg)
        raise TransportError(f"comm sync at {site!r} failed after the full retry ladder (degrade=False)")
    report.degraded_step = "local_state"
    report.stale = True
    if mview is not None:
        report.peers_lost = mview.lost()
        # A rank that fell all the way to local state learned nothing reliable
        # about the world: only *attributed* failures (PeerLostError.peers)
        # marked peers lost, and a rank whose collectives all died as
        # unattributed timeouts exits with an EMPTY lost set — its next sync
        # would then skip agreement and stall a full-world collective while
        # the peers that DID attribute the failure agree on a subset without
        # it. Poison the view (the restarting-process contract of
        # suspect_all) so the next sync re-agrees from the board regardless
        # of which side of the attribution race this rank landed on.
        mview.suspect_all()
    _obs.record_comm_degradation(site, "local_state")
    _obs.set_comm_stale(site, True)
    _publish(report, cfg)
    return dict(state)


# ----------------------------------------------------------------- gather-fn compatibility path


def sync_with_gather_fn(
    state: Dict[str, Any],
    reductions: Dict[str, Any],
    gather_fn: Callable,
    *,
    site: str = "sync_state_host",
) -> Dict[str, Any]:
    """Leaf-at-a-time sync for callers injecting a reference-protocol gather.

    An injected ``gather_fn`` returns already-decoded peer tensors, so no codec
    applies; semantics match the pre-comm ``sync_state_host`` exactly — the
    ``_update_count`` special case fires only when the key is *not* already
    in ``reductions``.
    """
    if _OBS.enabled:
        nbytes = _obs.tree_nbytes(state)
        _obs.record_comm_payload(site, nbytes, nbytes)
    with _obs.comm_span("comm.sync_gather_fn", site=site):
        synced = dict(state)
        for name, reduction in reductions.items():
            val = state[name]
            device = _leaf_device(val)
            if isinstance(val, list):
                if not val:
                    continue
                gathered = [device_tensor(r, device) for r in gather_fn(dim_zero_cat(val))]
                synced[name] = [dim_zero_cat(gathered)]
                continue
            tag = "callable" if callable(reduction) else ("none" if reduction is None else reduction)
            synced[name] = _reduce_rows(tag, reduction, gather_fn(device_tensor(val, device)), False, device)
        if "_update_count" in state and "_update_count" not in reductions:
            count = state["_update_count"]
            device = _leaf_device(count)
            synced["_update_count"] = _reduce_stack(
                "sum", torch.stack([device_tensor(r, device) for r in gather_fn(device_tensor(count, device))])
            )
    return synced


def gather_metric_leaves(
    input_dict: Dict[str, Any],
    gather_fn: Callable,
    group: Optional[Any] = None,
    *,
    site: str = "Metric._sync_dist",
) -> Dict[str, Any]:
    """``Metric._sync_dist``'s gather step, routed through the comm plane.

    Applies ``gather_fn`` to every tensor leaf (the reference ``dist_sync_fn``
    protocol) under a comm span, with raw==wire byte accounting — an injected
    gather moves decoded tensors, so there is nothing to compress here; the
    default ``gather_all_tensors`` rides the configured transport underneath.
    """
    if _OBS.enabled:
        nbytes = _obs.tree_nbytes(input_dict)
        _obs.record_comm_payload(site, nbytes, nbytes)
    with _obs.comm_span("comm.gather_leaves", site=site):
        return apply_to_collection(input_dict, Tensor, gather_fn, group=group)


# ----------------------------------------------------------------- in-trace path


def sync_pytree_in_trace(
    state: Dict[str, Any],
    reductions: Dict[str, Any],
    axis_name: Any,
    codec: Any = None,
) -> Dict[str, Any]:
    """Device-path pytree sync: one collective per state over ``axis_name``.

    The device twin of :func:`sync_pytree` (``Metric.sync_state`` delegates
    here): list states ``dim_zero_cat`` then gather-as-cat; everything else
    routes through :func:`reduce_in_trace`. ``codec`` applies to gather-style
    leaves only (see :func:`reduce_in_trace`). ``_update_count`` is not a
    registered reduction and stays this rank's, as in the JAX package.
    """
    synced = dict(state)
    for name, reduction in reductions.items():
        val = state[name]
        if isinstance(val, list):
            synced[name] = val if not val else [reduce_in_trace(dim_zero_cat(val), "cat", axis_name, codec=codec)]
        else:
            synced[name] = reduce_in_trace(val, reduction, axis_name, codec=codec)
    return synced


def sync_state(
    state: Dict[str, Any],
    reductions: Dict[str, Any],
    *,
    axis_name: Any = None,
    transport: Optional[Transport] = None,
    config: Optional[CommConfig] = None,
    site: str = "comm.sync",
    codec: Any = None,
) -> Dict[str, Any]:
    """One entry, both execution contexts: device collectives over
    ``axis_name`` when it is given, host-planned otherwise."""
    if axis_name is not None:
        return sync_pytree_in_trace(state, reductions, axis_name, codec=codec)
    return sync_pytree(state, reductions, transport=transport, config=config, site=site)


_REDUCE_OPS = {"sum": "SUM", "mean": "SUM", "max": "MAX", "min": "MIN"}


def _collective(what: str, fn: Callable, x: Tensor, group: Any) -> None:
    """Run one collective, naming the backend and the device if it refuses."""
    try:
        fn()
    except RuntimeError as exc:
        backend = torch.distributed.get_backend(group)
        raise RuntimeError(
            f"{what} of a {x.dtype} tensor on {x.device} over the {backend} backend failed: {exc}"
        ) from exc


def _all_gather(x: Tensor, group: Any, order: Optional[List[int]]) -> List[Tensor]:
    """Every participant's ``x`` in ``axis_name``'s rank order (rows of the
    group permuted by ``order`` where the named mesh order differs)."""
    x = x.contiguous()
    rows = [torch.empty_like(x) for _ in range(torch.distributed.get_world_size(group))]
    _collective("all_gather", lambda: torch.distributed.all_gather(rows, x, group=group), x, group)
    return rows if order is None else [rows[i] for i in order]


def reduce_in_trace(x: Tensor, reduce_fx: Any, axis_name: Any, codec: Any = None) -> Tensor:
    """Apply one state reduction as a ``torch.distributed`` collective over
    ``axis_name`` on ``x``'s own device.

    ``sum``/``max``/``min`` are an ``all_reduce`` (``SUM``/``MAX``/``MIN``) on a
    copy of ``x``; ``mean`` is the ``SUM`` divided by the group size, in JAX's
    dtype (``lax.pmean`` is ``psum(x) / n``: an int32 state comes back
    float32). They are always lossless. ``cat`` is a tiled all-gather along
    dim 0, ``None`` the rank-stacked ``(world, ...)`` gather and a callable is
    applied to that stack — and these may gather *quantized*: pass
    ``codec="int8"`` (or an :class:`~metrics_tpu_torch.comm.codec.Int8BlockCodec`)
    to ship blockwise int8 codes + scales through the all-gather and
    dequantize on the far side, or ``codec="fp16"`` for a half-precision
    gather. ``x`` itself is never written. Nothing here reads a value on the
    host, so a step that calls it can be captured in a CUDA graph (NCCL).
    """
    group, order = resolve_axis(axis_name)
    if _OBS.enabled:
        _obs.record_traced_sync_bytes(
            "reduce_in_trace", str(reduce_fx) if not callable(reduce_fx) else "callable", _obs.tree_nbytes(x)
        )
    if isinstance(reduce_fx, str) and reduce_fx in _REDUCE_OPS:
        out = x.detach().clone(memory_format=torch.contiguous_format)
        op = getattr(torch.distributed.ReduceOp, _REDUCE_OPS[reduce_fx])
        _collective("all_reduce", lambda: torch.distributed.all_reduce(out, op=op, group=group), out, group)
        if reduce_fx == "mean":
            return out / torch.distributed.get_world_size(group)
        return out
    if reduce_fx not in ("cat", None) and not callable(reduce_fx):
        raise ValueError(f"Unsupported dist_reduce_fx inside trace: {reduce_fx!r}")

    x = x.detach()
    n = x.numel()
    c = get_codec(codec) if isinstance(codec, str) else codec
    if c is not None and c.name == "fp16" and x.ndim > 0:
        stacked = torch.stack(_all_gather(x.to(torch.float16), group, order)).to(x.dtype)
        if reduce_fx == "cat":
            return stacked.reshape((-1, *x.shape[1:]))
        return reduce_fx(stacked) if callable(reduce_fx) else stacked
    if c is not None and not c.lossless and hasattr(c, "encode_in_trace") and n > 0 and x.ndim > 0:
        codes, scales = c.encode_in_trace(x)
        stacked_codes = torch.stack(_all_gather(codes, group, order))  # (world, padded)
        stacked_scales = torch.stack(_all_gather(scales, group, order))  # (world, blocks)
        world = stacked_codes.shape[0]
        stacked = c.decode_in_trace(stacked_codes, stacked_scales, n, x.dtype).reshape((world, *x.shape))
        if reduce_fx == "cat":
            return stacked.reshape((-1, *x.shape[1:]))
        if callable(reduce_fx):
            return reduce_fx(stacked)
        return stacked
    rows = _all_gather(x, group, order)
    if reduce_fx == "cat":
        return torch.cat(rows, dim=0)
    gathered = torch.stack(rows)  # stack: (world, ...)
    return reduce_fx(gathered) if callable(reduce_fx) else gathered
