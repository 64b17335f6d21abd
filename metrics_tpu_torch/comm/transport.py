"""Host transports: who moves the wire buffers, and what happens when they don't
(port of ``metrics_tpu/comm/transport.py``).

A :class:`Transport` is the buffer-level boundary of the comm plane: it moves
numpy arrays between processes and knows nothing about metric states, codecs,
or plans. The contract is the classic same-shape ``allgather`` (every rank
passes an identically-shaped array, gets back the per-rank list in rank order);
transports that can also do per-rank exact-size ``broadcast_from`` advertise it
with ``supports_broadcast`` so :func:`gather_ragged` can skip pad-to-max when
padding would dominate the wire.

Concrete transports:

- :class:`LocalTransport` — world 1, identity. The single-process default.
- :class:`MultihostTransport` — ``torch.distributed`` over a real multi-process
  job (``all_gather`` / ``broadcast`` of CPU tensors over a gloo group; the
  counterpart of the JAX package's ``multihost_utils``).
- :class:`LoopbackWorld` — an in-process N-rank world over threads + barriers,
  for protocol tests and fault rehearsal without a cluster.
- :class:`ReplicaFakeTransport` / :class:`ScriptedFakeTransport` — single-caller
  fakes: every peer mirrors the caller, or replies are scripted per call.
- :class:`FlakyTransport` / :class:`StallTransport` / :class:`DeadPeerTransport`
  — fault injectors wrapping any inner transport, for exercising the retry →
  degradation ladder.

Failure vocabulary: :class:`TransportError` (transient collective failure),
:class:`TransportTimeout` (a peer stalled past the deadline),
:class:`PeerLostError` (membership broke — retrying the same world cannot
succeed; carries the *attributed* straggler ranks when the transport knows
them). The plane's ladder treats them uniformly except that a lost peer
skips straight past same-step retries.

Membership-capable transports (``supports_membership = True``) additionally
expose the primitives :mod:`metrics_tpu_torch.comm.membership` builds its
two-phase live-set agreement on: ``membership_exchange`` (a deadlined,
watermarked deposit/collect board that cannot deadlock on dead peers),
``subset(ranks)`` (a transport over an agreed sub-world), and ``reset()``
(repair a world whose barriers an aborted round broke). :class:`LoopbackWorld`
implements all three; :class:`MultihostTransport` does not (agreement over a
multi-process job needs an out-of-band store), so the plane's ``live_subset``
rung does not engage there.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "DeadPeerTransport",
    "FlakyTransport",
    "LocalTransport",
    "LoopbackWorld",
    "MultihostTransport",
    "PeerLostError",
    "ReplicaFakeTransport",
    "ScriptedFakeTransport",
    "StallTransport",
    "Transport",
    "TransportError",
    "TransportTimeout",
    "gather_ragged",
]


class TransportError(RuntimeError):
    """A collective failed for a reason worth retrying (transient fabric/peer hiccup)."""


class TransportTimeout(TransportError):
    """A peer stalled past the configured deadline."""


class PeerLostError(TransportError):
    """Membership degraded — a peer is gone; retrying the same world cannot succeed.

    ``peers`` carries the attributed straggler/dead ranks when the transport can
    name them (empty when it can't) — the membership layer's suspicion counters
    feed on exactly this attribution.
    """

    def __init__(self, message: str = "peer left the membership", peers: Sequence[int] = ()) -> None:
        super().__init__(message)
        self.peers: Tuple[int, ...] = tuple(sorted(int(p) for p in peers))


class Transport:
    """Buffer-level collective boundary. Same-shape allgather is the one requirement."""

    name = "transport"
    supports_broadcast = False
    supports_membership = False

    def world_size(self) -> int:
        raise NotImplementedError

    def allgather(self, x: np.ndarray) -> List[np.ndarray]:
        """Every rank passes an identically-shaped array; returns rank-ordered rows."""
        raise NotImplementedError

    def broadcast_from(self, x: Optional[np.ndarray], root: int, shape: Any, dtype: Any) -> np.ndarray:
        """Root's exact-size array to every rank (non-roots pass ``x=None``)."""
        raise NotImplementedError(f"{self.name} does not support broadcast_from")


class LocalTransport(Transport):
    """World of one — every collective is the identity."""

    name = "local"
    supports_broadcast = True

    def world_size(self) -> int:
        return 1

    def allgather(self, x: np.ndarray) -> List[np.ndarray]:
        return [np.asarray(x)]

    def broadcast_from(self, x: Optional[np.ndarray], root: int, shape: Any, dtype: Any) -> np.ndarray:
        assert root == 0 and x is not None
        return np.asarray(x)


_HOST_GROUPS: Dict[Any, Any] = {}  # process group (None: the world) -> the gloo group its host buffers take
_HOST_WORLD: List[Any] = [None]  # the default group the cache was filled under
_HOST_GROUPS_LOCK = threading.Lock()


def _host_group(group: Optional[Any]) -> Any:
    """``group`` itself where its backend takes CPU tensors to gloo, else one
    gloo group over the same ranks, made at the first sync over ``group`` and
    kept until the default process group changes.

    The world's twin is a plain ``dist.new_group(backend="gloo")``, which every
    rank enters, as every rank reaches the first sync over the world. A
    subgroup's twin is made with ``use_local_synchronization=True``, so only
    its own ranks enter, as only they sync over it; torch names such a group
    by its ranks and the number of groups each member has made, so the
    members must have made the same number before (as every rank of a
    ``DeviceMesh`` has)."""
    dist = torch.distributed
    with _HOST_GROUPS_LOCK:
        world = dist.group.WORLD
        if _HOST_WORLD[0] is not world:  # a new world: the old one's groups are destroyed
            _HOST_GROUPS.clear()
            _HOST_WORLD[0] = world
        host = _HOST_GROUPS.get(group)
        if host is None:
            pg = world if group is None else group
            if "gloo" in str(dist.get_backend(pg)):  # gloo, or cpu:gloo beside cuda:nccl
                host = pg
            elif pg is world:
                host = dist.new_group(backend="gloo")
            else:
                ranks = dist.get_process_group_ranks(pg)
                host = dist.new_group(ranks=ranks, backend="gloo", use_local_synchronization=True)
            _HOST_GROUPS[group] = host
        return host


class MultihostTransport(Transport):
    """The real thing: a multi-process job through ``torch.distributed``.

    Buffers are numpy on both sides, as the JAX package's ``multihost_utils``
    path stages them through the host: each is sent as its raw bytes in a CPU
    ``uint8`` tensor (so every numpy dtype crosses, whatever the backend's
    dtype table), gathered with ``all_gather`` or sent with ``broadcast``.
    ``group`` (default: the whole world) names the ranks. Where its backend
    does not take CPU tensors to gloo (NCCL on a multi-GPU job), the first
    collective over it makes one gloo group over the same ranks, entered by
    those ranks only (see :func:`_host_group`), so host buffers never go to
    NCCL.
    """

    name = "multihost"
    supports_broadcast = True

    def __init__(self, group: Optional[Any] = None) -> None:
        self._group = group

    def _pg(self) -> Any:
        return _host_group(self._group)

    def world_size(self) -> int:
        return torch.distributed.get_world_size(self._group)

    @property
    def rank(self) -> int:
        return torch.distributed.get_rank(self._group)

    def allgather(self, x: np.ndarray) -> List[np.ndarray]:
        x = np.asarray(x)
        mine = torch.from_numpy(np.array(x, order="C").reshape(-1).view(np.uint8))
        rows = [torch.empty_like(mine) for _ in range(self.world_size())]
        torch.distributed.all_gather(rows, mine, group=self._pg())
        return [r.numpy().view(x.dtype).reshape(x.shape) for r in rows]

    def broadcast_from(self, x: Optional[np.ndarray], root: int, shape: Any, dtype: Any) -> np.ndarray:
        dist = torch.distributed
        shape, dtype = tuple(int(d) for d in shape), np.dtype(dtype)
        if self.rank == root:
            buf = np.array(x, dtype, order="C").reshape(-1).view(np.uint8)
        else:
            buf = np.zeros(int(np.prod(shape, dtype=np.int64)) * dtype.itemsize, np.uint8)
        payload = torch.from_numpy(buf)
        group = self._pg()
        src = root if self._group is None else dist.get_global_rank(self._group, root)
        dist.broadcast(payload, src=src, group=group)
        return payload.numpy().view(dtype).reshape(shape)


# --------------------------------------------------------------- call cancellation

# Cooperative abandonment channel for deadlined collectives: the plane's
# deadline wrapper runs each collective in a worker thread and, on timeout,
# sets the worker's cancel event. A real multihost collective cannot observe
# it (no abort exists), but the in-process transports check it before touching
# shared barriers — so a late-completing abandoned call can never deposit into
# a fresh attempt's round.
_CALL_CANCEL = threading.local()


def set_call_cancel_event(event: Optional[threading.Event]) -> None:
    """Install (or clear) the current thread's collective-cancel event."""
    _CALL_CANCEL.event = event


def current_call_cancelled() -> bool:
    event = getattr(_CALL_CANCEL, "event", None)
    return event is not None and event.is_set()


# --------------------------------------------------------------------- loopback world


class LoopbackWorld:
    """An in-process N-rank world: one transport per simulated rank, matched up
    with barriers, so the *real* wire protocols (pad-to-max, exact broadcast,
    plan execution) run end to end without a cluster.

    Every rank must make the same sequence of collective calls; a rank that
    falls behind past ``timeout`` breaks the barrier and every participant
    raises an *attributed* :class:`PeerLostError` naming the rank(s) that fell
    behind (or :class:`TransportTimeout` when no straggler can be named)
    instead of deadlocking. :meth:`reset` repairs the broken barriers so the
    world survives an aborted round, and the world carries the membership
    primitives (deposit board, sub-world groups) the agreement protocol needs.
    """

    def __init__(self, world: int, timeout: float = 30.0) -> None:
        if world < 1:
            raise ValueError("world must be >= 1")
        self.world = world
        self.timeout = timeout
        self._deposit_barrier = threading.Barrier(world)
        self._read_barrier = threading.Barrier(world)
        self._slots: List[Optional[np.ndarray]] = [None] * world
        # monotonic per-rank collective-entry counters: after a barrier abort,
        # the ranks with strictly fewer arrivals than the observer are the ones
        # that never showed up — that's the straggler attribution
        self._arrivals = [0] * world
        self._generation = 0
        self._state_lock = threading.Lock()
        # membership board: phase -> per-rank (seq, payload) cells, under one
        # condition; seq is a global monotonic stamp so readers can tell a
        # fresh deposit from last round's leftovers via per-reader watermarks
        self._mb_cond = threading.Condition()
        self._mb_seq = 0
        self._mb_cells: Dict[str, List[Optional[Tuple[int, Any]]]] = {}
        self._subgroups: Dict[Tuple[int, ...], "_SubGroup"] = {}

    def reset(self) -> None:
        """Repair the world after an aborted or abandoned round.

        Both barriers are reset unconditionally (kicking any abandoned waiter a
        deadline-expired collective left behind — it raises instead of
        occupying a barrier seat in the next round), slots are cleared, and the
        world generation is bumped so an exchange that straddles the reset
        fails loudly instead of pairing with the next round's deposits.
        """
        with self._state_lock:
            self._generation += 1
            self._deposit_barrier.reset()
            self._read_barrier.reset()
            self._slots = [None] * self.world
            groups = list(self._subgroups.values())
        for g in groups:
            g.repair()

    # ---------------------------------------------------------- membership board

    def deposit_membership(self, rank: int, phase: str, payload: Any) -> int:
        with self._mb_cond:
            self._mb_seq += 1
            cells = self._mb_cells.setdefault(phase, [None] * self.world)
            cells[rank] = (self._mb_seq, payload)
            self._mb_cond.notify_all()
            return self._mb_seq

    def collect_membership(
        self,
        rank: int,
        phase: str,
        expected: Sequence[int],
        deadline_s: float,
        watermarks: Dict[int, int],
        grace_s: float = 0.0,
    ) -> Dict[int, Tuple[int, Any]]:
        """Wait until every ``expected`` rank has a deposit fresher than its
        watermark (holding a further ``grace_s`` for opportunistic deposits from
        ranks *outside* ``expected`` — that is how rejoiners get noticed), or
        ``deadline_s`` expires; return every fresh deposit seen, by rank."""
        start = time.monotonic()
        deadline = start + deadline_s
        grace_end = start + min(grace_s, deadline_s)
        expected = [int(r) for r in expected]
        with self._mb_cond:
            while True:
                cells = self._mb_cells.get(phase) or []
                fresh = {
                    r: cell
                    for r, cell in enumerate(cells)
                    if cell is not None and cell[0] > watermarks.get(r, -1)
                }
                now = time.monotonic()
                have_expected = all(r in fresh or r == rank for r in expected)
                if have_expected and now >= grace_end:
                    return fresh
                if now >= deadline:
                    return fresh
                horizon = grace_end if have_expected else deadline
                self._mb_cond.wait(timeout=max(1e-4, horizon - now))

    # ---------------------------------------------------------- sub-world groups

    def subgroup(self, members: Tuple[int, ...]) -> "_SubGroup":
        members = tuple(sorted(int(m) for m in members))
        if not members or any(not 0 <= m < self.world for m in members):
            raise ValueError(f"subgroup members {members} outside world {self.world}")
        with self._state_lock:
            group = self._subgroups.get(members)
            if group is None:
                group = _SubGroup(self, members)
                self._subgroups[members] = group
            return group

    def transport(self, rank: int) -> "_LoopbackTransport":
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} outside world {self.world}")
        return _LoopbackTransport(self, rank)

    def run(self, fns: Sequence[Callable[["_LoopbackTransport"], Any]]) -> List[Any]:
        """Run one callable per rank (each given its transport); returns results
        in rank order, re-raising the first per-rank exception."""
        if len(fns) != self.world:
            raise ValueError(f"need exactly {self.world} rank fns, got {len(fns)}")
        results: List[Any] = [None] * self.world
        errors: List[Optional[BaseException]] = [None] * self.world

        def _runner(rank: int) -> None:
            try:
                results[rank] = fns[rank](self.transport(rank))
            except BaseException as exc:  # noqa: BLE001 — propagated to the caller below
                errors[rank] = exc
                self._deposit_barrier.abort()
                self._read_barrier.abort()

        threads = [threading.Thread(target=_runner, args=(r,), daemon=True) for r in range(self.world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(self.timeout * 4)
        for exc in errors:
            if exc is not None:
                raise exc
        return results

    def _exchange(self, rank: int, x: Optional[np.ndarray]) -> List[Optional[np.ndarray]]:
        if current_call_cancelled():
            raise TransportError(f"loopback rank {rank}: abandoned deadline-expired collective discarded")
        with self._state_lock:
            self._arrivals[rank] += 1
            gen = self._generation
        self._slots[rank] = None if x is None else np.asarray(x)
        try:
            self._deposit_barrier.wait(self.timeout)
            out = list(self._slots)
            self._read_barrier.wait(self.timeout)
        except threading.BrokenBarrierError:
            with self._state_lock:
                same_gen = self._generation == gen
                me = self._arrivals[rank]
                stragglers = [r for r in range(self.world) if r != rank and self._arrivals[r] < me]
            if same_gen:
                # only break the round we were actually part of — if a reset
                # already repaired the world, the fresh barriers stay usable
                self._deposit_barrier.abort()
                self._read_barrier.abort()
            if stragglers:
                raise PeerLostError(
                    f"loopback rank {rank}: peers {stragglers} fell behind mid-collective",
                    peers=stragglers,
                ) from None
            raise TransportTimeout(f"loopback rank {rank}: a peer stalled or died mid-collective") from None
        if self._generation != gen:
            raise TransportError(f"loopback rank {rank}: world reset mid-collective (stale exchange discarded)")
        return out


class _SubGroup:
    """A sub-world of a :class:`LoopbackWorld`: its own barrier pair and slots
    over a fixed member tuple, so an agreed live subset can run the real wire
    protocols without the dead ranks' barrier seats. Cached per member tuple on
    the parent world — every survivor computes the same agreed set, so every
    survivor lands on the same group object."""

    def __init__(self, world: LoopbackWorld, members: Tuple[int, ...]) -> None:
        self.members = members
        self.timeout = world.timeout
        self._index = {g: i for i, g in enumerate(members)}
        n = len(members)
        self._deposit_barrier = threading.Barrier(n)
        self._read_barrier = threading.Barrier(n)
        self._slots: List[Optional[np.ndarray]] = [None] * n
        self._arrivals = [0] * n
        self._lock = threading.Lock()

    def repair(self) -> None:
        with self._lock:
            self._deposit_barrier.reset()
            self._read_barrier.reset()
            self._slots = [None] * len(self.members)

    def transport(self, global_rank: int) -> "_LoopbackSubTransport":
        if global_rank not in self._index:
            raise ValueError(f"rank {global_rank} is not a member of subgroup {self.members}")
        return _LoopbackSubTransport(self, global_rank)

    def _exchange(self, idx: int, x: Optional[np.ndarray]) -> List[Optional[np.ndarray]]:
        if current_call_cancelled():
            raise TransportError(
                f"loopback subgroup {self.members}: abandoned deadline-expired collective discarded"
            )
        with self._lock:
            self._arrivals[idx] += 1
        self._slots[idx] = None if x is None else np.asarray(x)
        try:
            self._deposit_barrier.wait(self.timeout)
            out = list(self._slots)
            self._read_barrier.wait(self.timeout)
        except threading.BrokenBarrierError:
            self._deposit_barrier.abort()
            self._read_barrier.abort()
            with self._lock:
                me = self._arrivals[idx]
                stragglers = [self.members[i] for i in range(len(self.members)) if i != idx and self._arrivals[i] < me]
            if stragglers:
                raise PeerLostError(
                    f"loopback subgroup {self.members}: peers {stragglers} fell behind mid-collective",
                    peers=stragglers,
                ) from None
            raise TransportTimeout(
                f"loopback subgroup {self.members}: a peer stalled or died mid-collective"
            ) from None
        return out


class _LoopbackSubTransport(Transport):
    """Transport over an agreed sub-world: global ranks map to dense subset
    indices, ``world_size()`` is the subset size, and plan execution runs
    unchanged (plans are laid out against ``transport.world_size()``)."""

    name = "loopback_subset"
    supports_broadcast = True

    def __init__(self, group: _SubGroup, global_rank: int) -> None:
        self._group = group
        self.global_rank = global_rank
        self.rank = group._index[global_rank]  # subset index: what plan roots mean

    @property
    def members(self) -> Tuple[int, ...]:
        return self._group.members

    def reset(self) -> None:
        self._group.repair()

    def world_size(self) -> int:
        return len(self._group.members)

    def allgather(self, x: np.ndarray) -> List[np.ndarray]:
        rows = self._group._exchange(self.rank, np.asarray(x))
        if any(r is None for r in rows):
            raise TransportError(f"loopback subgroup {self.members}: a peer deposited nothing")
        return [np.asarray(r) for r in rows]

    def broadcast_from(self, x: Optional[np.ndarray], root: int, shape: Any, dtype: Any) -> np.ndarray:
        rows = self._group._exchange(self.rank, x if self.rank == root else None)
        got = rows[root]
        if got is None:
            raise TransportError(f"loopback subgroup {self.members}: root {root} deposited nothing")
        return np.asarray(got)


class _LoopbackTransport(Transport):
    name = "loopback"
    supports_broadcast = True
    supports_membership = True

    def __init__(self, world: LoopbackWorld, rank: int) -> None:
        self._world = world
        self.rank = rank

    def world_size(self) -> int:
        return self._world.world

    def allgather(self, x: np.ndarray) -> List[np.ndarray]:
        rows = self._world._exchange(self.rank, np.asarray(x))
        if any(r is None for r in rows):
            raise TransportError(f"loopback rank {self.rank}: a peer deposited nothing")
        return [np.asarray(r) for r in rows]

    def broadcast_from(self, x: Optional[np.ndarray], root: int, shape: Any, dtype: Any) -> np.ndarray:
        rows = self._world._exchange(self.rank, x if self.rank == root else None)
        got = rows[root]
        if got is None:
            raise TransportError(f"loopback rank {self.rank}: root {root} deposited nothing")
        return np.asarray(got)

    # ------------------------------------------------------ membership primitives

    def reset(self) -> None:
        self._world.reset()

    def membership_exchange(
        self,
        phase: str,
        payload: Any,
        *,
        deadline_s: float,
        expected: Sequence[int],
        watermarks: Dict[int, int],
        grace_s: float = 0.0,
    ) -> Dict[int, Tuple[int, Any]]:
        """Deposit ``payload`` on the world's membership board under ``phase``
        and collect every fresh deposit (see ``collect_membership``). Bounded by
        ``deadline_s`` — a dead peer costs the deadline, never a deadlock."""
        self._world.deposit_membership(self.rank, phase, payload)
        return self._world.collect_membership(self.rank, phase, expected, deadline_s, watermarks, grace_s)

    def subset(self, ranks: Sequence[int]) -> Transport:
        members = tuple(sorted(int(r) for r in ranks))
        if members == tuple(range(self._world.world)):
            return self
        return self._world.subgroup(members).transport(self.rank)


# --------------------------------------------------------------------- test fakes


class ReplicaFakeTransport(Transport):
    """Every peer mirrors the caller — the cheapest way to fake world=N when
    per-rank contents don't matter (sum → N·x, cat → x repeated N times)."""

    name = "replica_fake"
    supports_broadcast = True

    def __init__(self, world: int) -> None:
        self._world = int(world)
        self.calls = 0

    def world_size(self) -> int:
        return self._world

    def allgather(self, x: np.ndarray) -> List[np.ndarray]:
        self.calls += 1
        x = np.asarray(x)
        return [x.copy() for _ in range(self._world)]

    def broadcast_from(self, x: Optional[np.ndarray], root: int, shape: Any, dtype: Any) -> np.ndarray:
        self.calls += 1
        assert x is not None  # with mirrored peers the caller is every root
        return np.asarray(x)


class ScriptedFakeTransport(Transport):
    """Replies scripted per call: ``script[i]`` is the rank-ordered row list the
    i-th allgather returns (the caller's own row replaced by its live buffer)."""

    name = "scripted_fake"

    def __init__(self, world: int, script: Sequence[Sequence[np.ndarray]], rank: int = 0) -> None:
        self._world = int(world)
        self._script = [list(rows) for rows in script]
        self._rank = rank
        self.calls = 0

    def world_size(self) -> int:
        return self._world

    def allgather(self, x: np.ndarray) -> List[np.ndarray]:
        if self.calls >= len(self._script):
            raise TransportError(f"scripted transport exhausted after {len(self._script)} calls")
        rows = [np.asarray(r) for r in self._script[self.calls]]
        rows[self._rank] = np.asarray(x)
        self.calls += 1
        return rows


class _MembershipPassthrough:
    """Mixin for wrappers: forward the membership primitives to the wrapped
    transport so fault injection composes with the agreement protocol."""

    _inner: Transport

    @property
    def supports_membership(self) -> bool:  # type: ignore[override]
        return getattr(self._inner, "supports_membership", False)

    def reset(self) -> None:
        reset = getattr(self._inner, "reset", None)
        if reset is not None:
            reset()

    def membership_exchange(self, phase: str, payload: Any, **kwargs: Any) -> Dict[int, Tuple[int, Any]]:
        return self._inner.membership_exchange(phase, payload, **kwargs)  # type: ignore[attr-defined]

    def subset(self, ranks: Sequence[int]) -> Transport:
        return self._inner.subset(ranks)  # type: ignore[attr-defined]


class FlakyTransport(_MembershipPassthrough, Transport):
    """Raise on the first ``fail`` collective calls, then delegate — the
    transient-failure injector for retry tests."""

    name = "flaky"

    def __init__(self, inner: Transport, fail: int = 1, exc: Callable[[], Exception] = TransportError) -> None:
        self._inner = inner
        self._remaining = int(fail)
        self._exc = exc
        self.failures_injected = 0

    @property
    def supports_broadcast(self) -> bool:  # type: ignore[override]
        return self._inner.supports_broadcast

    @property
    def rank(self) -> Optional[int]:
        return getattr(self._inner, "rank", None)

    def world_size(self) -> int:
        return self._inner.world_size()

    def _maybe_fail(self) -> None:
        if self._remaining > 0:
            self._remaining -= 1
            self.failures_injected += 1
            raise self._exc()

    def allgather(self, x: np.ndarray) -> List[np.ndarray]:
        self._maybe_fail()
        return self._inner.allgather(x)

    def broadcast_from(self, x: Optional[np.ndarray], root: int, shape: Any, dtype: Any) -> np.ndarray:
        self._maybe_fail()
        return self._inner.broadcast_from(x, root, shape, dtype)


class StallTransport(_MembershipPassthrough, Transport):
    """Sleep ``stall_s`` before the first ``stalls`` collectives complete — what a
    wedged peer looks like to the plane's deadline. The stalled collective DOES
    eventually run against the inner transport, which is exactly the
    late-completion hazard the plane's generation-stamped deadline wrapper must
    survive."""

    name = "stall"

    def __init__(self, inner: Transport, stall_s: float, stalls: int = 1) -> None:
        self._inner = inner
        self._stall_s = stall_s
        self._remaining = int(stalls)

    @property
    def supports_broadcast(self) -> bool:  # type: ignore[override]
        return self._inner.supports_broadcast

    @property
    def rank(self) -> Optional[int]:
        return getattr(self._inner, "rank", None)

    def world_size(self) -> int:
        return self._inner.world_size()

    def _maybe_stall(self) -> None:
        if self._remaining > 0:
            self._remaining -= 1
            time.sleep(self._stall_s)

    def allgather(self, x: np.ndarray) -> List[np.ndarray]:
        self._maybe_stall()
        return self._inner.allgather(x)

    def broadcast_from(self, x: Optional[np.ndarray], root: int, shape: Any, dtype: Any) -> np.ndarray:
        self._maybe_stall()
        return self._inner.broadcast_from(x, root, shape, dtype)


class DeadPeerTransport(Transport):
    """Every collective fails with :class:`PeerLostError` — the bottom of the
    ladder: membership is broken and only local state remains."""

    name = "dead_peer"

    def __init__(self, world: int = 2) -> None:
        self._world = world

    def world_size(self) -> int:
        return self._world

    def allgather(self, x: np.ndarray) -> List[np.ndarray]:
        raise PeerLostError("peer left the membership")

    def broadcast_from(self, x: Optional[np.ndarray], root: int, shape: Any, dtype: Any) -> np.ndarray:
        raise PeerLostError("peer left the membership")


# --------------------------------------------------------------------- ragged gather


def _shape_vector(x: np.ndarray) -> np.ndarray:
    return np.asarray(x.shape, dtype=np.int64) if x.ndim else np.zeros((0,), np.int64)


def gather_ragged(
    transport: Transport,
    x: np.ndarray,
    *,
    rank: Optional[int] = None,
    max_pad_ratio: float = 1.25,
) -> List[np.ndarray]:
    """Gather a possibly-ragged array from every rank, in rank order.

    The reference protocol (torchmetrics ``gather_all_tensors``): gather shape
    vectors first; equal shapes → one allgather; unequal → pad to the
    elementwise max along every dim, gather, trim each rank back. Mixed ranks
    (different ``ndim``) are a protocol error, as in the reference.

    When the transport supports exact-size broadcast and pad-to-max would ship
    more than ``max_pad_ratio``× the real payload, each rank broadcasts its
    exact buffer instead — W rounds, zero pad bytes; the transfer planner leans
    on this for heavily skewed ``cat`` states.
    """
    x = np.asarray(x)
    world = transport.world_size()
    if world == 1:
        return [x]
    shapes = transport.allgather(_shape_vector(x))
    if any(s.shape != shapes[0].shape for s in shapes):
        ranks = sorted({int(s.size) for s in shapes})
        raise ValueError(
            f"gather_ragged: mixed-rank shards (ndims {ranks}); the pad-to-max protocol "
            "requires every process to contribute the same number of dimensions"
        )
    all_shapes = [tuple(int(d) for d in s) for s in shapes]
    if all(s == all_shapes[0] for s in all_shapes):
        return transport.allgather(x)
    max_shape = tuple(max(s[d] for s in all_shapes) for d in range(len(all_shapes[0])))
    total = sum(int(np.prod(s, dtype=np.int64)) for s in all_shapes)
    padded_total = world * int(np.prod(max_shape, dtype=np.int64))
    if rank is None:
        rank = getattr(transport, "rank", None)
    # exact-size broadcast needs to know which rank WE are (the root must pass
    # its live buffer); without that, pad-to-max is the only correct protocol
    if transport.supports_broadcast and rank is not None and total > 0 and padded_total > max_pad_ratio * total:
        out = []
        for r in range(world):
            mine = r == rank
            out.append(transport.broadcast_from(x if mine else None, r, all_shapes[r], x.dtype))
        return out
    pad = [(0, m - s) for m, s in zip(max_shape, x.shape)]
    padded = np.pad(x, pad)
    gathered = transport.allgather(padded)
    return [np.asarray(gathered[i])[tuple(slice(0, d) for d in all_shapes[i])] for i in range(world)]
