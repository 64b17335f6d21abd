"""Membership layer: who is alive, and how every survivor agrees on it
(port of ``metrics_tpu/comm/membership.py``).

This module turns the comm plane from fail-to-local into fail-to-quorum
(a degrade-don't-deadlock posture). Two pieces:

- :class:`WorldView` — one per process: per-peer health fed by *attributed*
  collective failures (``PeerLostError.peers``), cumulative suspicion
  counters (the cluster plane's failure detector consumes these), and the
  per-phase board watermarks that keep one agreement round from consuming a
  previous round's deposits.
- :func:`agree_live_set` — the two-phase agreement round. Phase A ("prop"):
  every participant deposits its presence on the transport's membership board
  and collects, under a deadline, every fresh deposit it can see — including
  opportunistic deposits from ranks it believed lost (that is automatic
  rejoin). Phase B ("commit"): every participant deposits the exact member
  tuple it observed; agreement holds only when every observed member committed
  the *same* tuple. A mismatch or a silent member drops to a retry round with
  the candidate set shrunk to the ranks that both showed up and committed —
  the candidate set can only shrink within a round sequence, so the loop is
  bounded; exhaustion raises :class:`MembershipError` and the sync ladder
  falls through to ``local_state``.

Why this is safe for metric state: every state is mergeable *cumulative*
full-state (the ``add_state(dist_reduce_fx=...)`` contract) — a sync over the
agreed sub-world is exactly the correct aggregate of the surviving ranks, and
a rejoined rank's next sync contributes its whole cumulative state, so nothing
is double-counted and nothing is lost.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Sequence, Tuple

from metrics_tpu_torch.obs import instrument as _obs

__all__ = [
    "MembershipError",
    "WorldView",
    "agree_live_set",
    "view_for",
]


class MembershipError(RuntimeError):
    """The survivors could not agree on a live set (quorum lost or rounds exhausted)."""


class WorldView:
    """Per-process view of which ranks are live, with suspicion bookkeeping.

    Thread-safe: the owning rank mutates it from the sync path while the
    cluster plane's failure detector reads :meth:`suspicion` from its tick
    thread. All mutation is attributed — a peer only becomes lost via an
    attributed collective failure (:meth:`mark_lost`), an explicit
    :meth:`suspect_all` (a restarting process must re-agree before its first
    sync), or a committed agreement round (:meth:`commit`).
    """

    def __init__(self, world: int, rank: int) -> None:
        self.world = int(world)
        self.rank = int(rank)
        self._lock = threading.Lock()
        self._lost: set = set()
        self._suspicion: Dict[int, int] = {}
        self._watermarks: Dict[str, Dict[int, int]] = {}
        self.epoch = 0
        self.last_agreed: Tuple[int, ...] = tuple(range(self.world))

    # ------------------------------------------------------------------ queries

    def live(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(r for r in range(self.world) if r not in self._lost)

    def lost(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(sorted(self._lost))

    def has_lost(self) -> bool:
        with self._lock:
            return bool(self._lost)

    def is_live(self, peer: int) -> bool:
        with self._lock:
            return int(peer) not in self._lost

    def suspicion(self) -> Dict[int, int]:
        """Cumulative attributed-failure counts per peer (never reset — the
        cluster plane reads edges, not levels)."""
        with self._lock:
            return dict(self._suspicion)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "world": self.world,
                "rank": self.rank,
                "epoch": self.epoch,
                "live": tuple(r for r in range(self.world) if r not in self._lost),
                "lost": tuple(sorted(self._lost)),
                "suspicion": dict(self._suspicion),
            }

    # ---------------------------------------------------------------- mutation

    def mark_lost(self, peers: Sequence[int], reason: str = "") -> None:
        with self._lock:
            for p in peers:
                p = int(p)
                if p == self.rank or not 0 <= p < self.world:
                    continue
                self._lost.add(p)
                self._suspicion[p] = self._suspicion.get(p, 0) + 1

    def observe_alive(self, peers: Sequence[int]) -> None:
        with self._lock:
            for p in peers:
                self._lost.discard(int(p))

    def suspect_all(self) -> None:
        """Mark every peer lost — a restarting/rejoining process calls this so
        its first sync goes through agreement instead of stalling a full-world
        collective it cannot complete alone."""
        with self._lock:
            for p in range(self.world):
                if p != self.rank:
                    self._lost.add(p)
                    self._suspicion[p] = self._suspicion.get(p, 0) + 1

    def commit(self, agreed: Sequence[int]) -> Tuple[int, ...]:
        agreed_t = tuple(sorted(int(r) for r in agreed))
        with self._lock:
            previous = self.last_agreed
            self._lost = set(range(self.world)) - set(agreed_t)
            self._lost.discard(self.rank)
            self.epoch += 1
            self.last_agreed = agreed_t
        # flight-recorder evidence (+ bundle dump when the live set SHRANK):
        # outside the lock — the dump walks registry/tracer state
        _obs.record_comm_live_set(f"rank{self.rank}", previous, agreed_t)
        return agreed_t

    def watermarks(self, phase: str) -> Dict[int, int]:
        """The (mutable) consumed-seq watermark map for one board phase."""
        with self._lock:
            return self._watermarks.setdefault(phase, {})


_VIEW_ATTR = "_metrics_tpu_world_view"


def view_for(transport: Any) -> WorldView:
    """The :class:`WorldView` attached to a transport (created on first use).

    Views live on the transport object so one process keeps one opinion per
    world across syncs; a fresh transport (a restarted process) starts with a
    clean all-live view — call :meth:`WorldView.suspect_all` on restart so the
    first sync re-agrees instead of assuming the old world.
    """
    view = getattr(transport, _VIEW_ATTR, None)
    if view is None:
        rank = getattr(transport, "rank", None)
        view = WorldView(transport.world_size(), int(rank) if rank is not None else 0)
        try:
            setattr(transport, _VIEW_ATTR, view)
        except (AttributeError, TypeError):
            pass
    return view


def agree_live_set(
    transport: Any,
    view: WorldView,
    *,
    deadline_s: float,
    grace_s: Optional[float] = None,
    max_rounds: Optional[int] = None,
) -> Tuple[int, ...]:
    """Run two-phase live-set agreement; returns the agreed member tuple.

    Every completing participant returns the SAME tuple (the phase-B equality
    check guarantees it), the view is committed to it, and lost peers' board
    deposits can never leak across rounds (per-phase watermarks). Raises
    :class:`MembershipError` when ``max_rounds`` pass without agreement.
    """
    world = int(transport.world_size())
    me = view.rank
    if world <= 1:
        return view.commit((me,))
    if grace_s is None:
        # every participant entering within the grace window sees the others'
        # phase-A deposits, so near-simultaneous entrants converge in one round
        grace_s = max(min(0.25 * deadline_s, 0.25), 0.01)
    if max_rounds is None:
        max_rounds = world + 2
    reset = getattr(transport, "reset", None)
    if reset is not None:
        reset()  # repair barriers an aborted payload round broke

    cand = set(view.live())
    cand.add(me)
    last_observed: Tuple[int, ...] = (me,)
    for _round in range(max_rounds):
        marks_p = view.watermarks("prop")
        deposits = transport.membership_exchange(
            "prop",
            tuple(sorted(cand)),
            deadline_s=deadline_s,
            expected=sorted(cand),
            watermarks=marks_p,
            grace_s=grace_s,
        )
        for r, (seq, _payload) in deposits.items():
            marks_p[int(r)] = max(marks_p.get(int(r), -1), int(seq))
        observed = {int(r) for r in deposits} | {me}
        mask = tuple(sorted(observed))
        last_observed = mask

        marks_c = view.watermarks("commit")
        commits = transport.membership_exchange(
            "commit",
            mask,
            deadline_s=deadline_s,
            expected=mask,
            watermarks=marks_c,
            grace_s=0.0,
        )
        for r, (seq, _payload) in commits.items():
            marks_c[int(r)] = max(marks_c.get(int(r), -1), int(seq))
        committed = {int(r) for r, (_seq, payload) in commits.items() if tuple(payload) == mask}
        committed.add(me)
        if observed <= committed:
            return view.commit(mask)
        # silent or divergent members drop out; the candidate set shrinks to
        # the ranks that both proposed and committed, and the round repeats
        cand = (observed & committed) | {me}
    raise MembershipError(
        f"rank {me}: no live-set agreement after {max_rounds} rounds (last observed {last_observed})"
    )
