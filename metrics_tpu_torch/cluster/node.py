"""ClusterNode — the per-engine supervisor that makes failover self-driving
(port of ``metrics_tpu/cluster/node.py``).

One daemon thread (or, in tests, manual :meth:`ClusterNode.tick` calls under a
:class:`~metrics_tpu_torch.cluster.store.ManualClock`) runs three loops in one:

1. **Membership + leadership.** Publish this node's heartbeat record every
   interval; hold/renew the leader lease while leading (renewal at half TTL).
   The lease epoch IS the repl fencing epoch, so at most one node is ever
   writable *into the lineage*: a deposed leader may accept a few local
   submits before its next tick notices, but its shipments die at the fenced
   transport boundary — the safety argument lives at the boundary, not in the
   scheduler (the JAX package's ``docs/source/cluster.md``).
2. **Failure detection.** A peer silent past ``suspect_after_s`` is suspected
   (counted, surfaced in ``health()['cluster']``); past ``confirm_after_s`` it
   is confirmed dead and excluded from election candidacy. Leader death needs
   no heartbeat inference at all — the lease self-expires in store time.
3. **Failover orchestration.** On lease expiry every eligible follower
   (bootstrapped, guard-SERVING) races the CAS, favourite first (lowest
   ``ReplicaLag``, ties by node id; non-favourites hold back one jittered
   backoff round). The winner drains + ``promote()``s at exactly the won
   lease epoch, then ships its new lineage to the surviving peers over
   ``link_factory`` fan-out; losers and the revived old leader re-attach as
   followers of the winner's link, fencing their old inbound link at the new
   epoch. A winner whose follower turns out never-bootstrapped backs off and
   retries on :class:`~metrics_tpu_torch.repl.errors.NotPromotableError` while the
   snapshot lands.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import replace as _dc_replace
from typing import Any, Dict, List, Optional, Tuple

from metrics_tpu_torch.cluster.config import ClusterConfig
from metrics_tpu_torch.cluster.errors import ClusterConfigError, CoordStoreError
from metrics_tpu_torch.cluster.store import Lease, Member
from metrics_tpu_torch.obs import instrument as _obs
from metrics_tpu_torch.obs.fleet import AGGREGATOR, node_snapshot
from metrics_tpu_torch.obs.registry import OBS as _OBS
from metrics_tpu_torch.repl.errors import NotPromotableError
from metrics_tpu_torch.repl.transport import FanoutTransport
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

__all__ = ["ClusterNode"]


class ClusterNode:
    """Supervise one :class:`~metrics_tpu_torch.engine.StreamingEngine`'s cluster role.

    ``start=True`` runs the supervisor thread at ``cfg.tick_interval_s``;
    ``start=False`` leaves ticking to the caller (deterministic tests drive
    :meth:`tick` by hand under a manual store clock). All timing decisions use
    ``cfg.store.now()`` — the store clock is the ONE clock lease math trusts.
    """

    def __init__(self, engine: Any, cfg: ClusterConfig, *, start: bool = True) -> None:
        if getattr(engine, "_cluster", None) is not None:
            raise ClusterConfigError("engine already supervised by a ClusterNode")
        self._engine = engine
        self.cfg = cfg
        self._store = cfg.store
        self._rng = random.Random(cfg.rng_seed if cfg.rng_seed is not None else hash(cfg.node_id))
        self._tick_lock = threading.Lock()

        self.role = "leader" if self._engine_is_writable() else "follower"
        self._lease: Optional[Lease] = None  # our own held lease (leader only)
        self._following: Optional[str] = None  # leader id our applier is attached to
        self.failovers = 0
        self.lease_renewals = 0
        self.suspicions = 0
        self.last_error: Optional[BaseException] = None
        self._suspected: Dict[str, float] = {}  # peer -> suspected-since (store time)
        self._comm_susp_seen: Dict[int, int] = {}  # comm rank -> consumed suspicion level
        self._last_heartbeat = float("-inf")
        self._election_backoff = 0.0
        self._next_attempt = float("-inf")  # candidacy/promote backoff gate (store time)
        self._promote_backoff = 0.0

        engine._cluster = self
        _obs.set_cluster_role(cfg.node_id, self.role)

        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._run, name=f"metrics-tpu-torch-cluster-{cfg.node_id}", daemon=True
            )
            self._thread.start()

    # ------------------------------------------------------------------ lifecycle

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception as exc:  # noqa: BLE001 — the supervisor must outlive any one bad tick
                self.last_error = exc
            self._stop.wait(self.cfg.tick_interval_s)

    def close(self, *, release: bool = True) -> None:
        """Stop supervising. ``release=True`` steps a leader's lease down so a
        peer can take over immediately instead of waiting out the TTL."""
        self._stop.set()
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=5.0)
        if release and self.role == "leader":
            try:
                self._store.release_lease(self.cfg.node_id)
            except CoordStoreError:
                pass  # unreachable store: the TTL is the fallback
        if getattr(self._engine, "_cluster", None) is self:
            self._engine._cluster = None

    # ------------------------------------------------------------------ engine view

    def _engine_is_writable(self) -> bool:
        eng = self._engine
        return not getattr(eng, "_repl_follower", False)

    def _engine_view(self) -> Tuple[str, bool, int]:
        """(health state, bootstrapped, lag_seqs) for membership/eligibility."""
        eng = self._engine
        try:
            state = eng.health()["state"]
        except Exception:  # noqa: BLE001 — an unreadable engine is not SERVING
            state = "QUARANTINED"
        if not getattr(eng, "_repl_follower", False):
            return state, True, 0  # a primary (or repl-less engine) is its own truth
        applier = getattr(eng, "_applier", None)
        if applier is None:
            return state, False, -1  # demoted but not yet attached to a lineage
        lag = applier.lag()
        lag_seqs = int(lag.seqs_behind) if applier.bootstrapped and not applier._gap else -1
        return state, bool(applier.bootstrapped), lag_seqs

    # ------------------------------------------------------------------ the tick

    def tick(self) -> None:
        """One supervisor pass: heartbeat, detect, lead-or-elect. Reentrant-safe;
        every store failure is absorbed and treated as lease loss, never success."""
        with self._tick_lock:
            now = self._store.now()
            health, bootstrapped, lag_seqs = self._engine_view()
            self._publish_heartbeat(now, health, bootstrapped, lag_seqs)
            self._detect_failures(now)
            if self.role == "leader":
                self._lead(now)
            else:
                self._follow(now, health, bootstrapped, lag_seqs)

    # ------------------------------------------------------------------ membership

    def _publish_heartbeat(self, now: float, health: str, bootstrapped: bool, lag_seqs: int) -> None:
        if now - self._last_heartbeat < self.cfg.heartbeat_interval_s:
            return
        fleet = None
        if _OBS.enabled:
            try:
                # piggyback this node's telemetry snapshot on the membership
                # record it already publishes; the leader merges every node's
                # into the fleet view on its next _lead() pass
                fleet = node_snapshot(self.cfg.node_id)
            except Exception:  # noqa: BLE001 — telemetry must not break membership
                fleet = None
        member = Member(
            node_id=self.cfg.node_id,
            role=self.role,
            health=health,
            bootstrapped=bootstrapped,
            lag_seqs=lag_seqs,
            heartbeat=now,
            fleet=fleet,
        )
        try:
            self._store.heartbeat(member)
            self._last_heartbeat = now
        except CoordStoreError as exc:
            self.last_error = exc

    def _detect_failures(self, now: float) -> None:
        try:
            members = self._store.members()
        except CoordStoreError as exc:
            self.last_error = exc
            return
        if _OBS.enabled and self.role == "leader":
            # the leader is the fleet's merge point: fold every member's
            # piggybacked telemetry snapshot into the process aggregator off
            # the member table this pass already fetched (zero extra store IO)
            AGGREGATOR.ingest_members(members.values())
        for peer in self.cfg.peers:
            rec = members.get(peer)
            silent = now - rec.heartbeat if rec is not None else float("inf")
            if rec is not None and silent >= self.cfg.suspect_after_s:
                if peer not in self._suspected:
                    # suspicion counts once per silence episode, on the edge
                    self._suspected[peer] = now
                    self.suspicions += 1
                    _obs.record_cluster_suspicion(self.cfg.node_id, peer)
            elif rec is not None:
                self._suspected.pop(peer, None)
        self._consume_comm_suspicion(now)

    def _consume_comm_suspicion(self, now: float) -> None:
        """Fold the comm plane's attributed-failure signal into detection.

        ``WorldView.suspicion()`` is a cumulative per-rank counter; we consume
        *edges* (the count moved since our last tick), so one bad collective
        suspects a peer exactly once — typically seconds before its heartbeats
        go silent. A fresh heartbeat un-suspects on the NEXT tick (the loop
        above runs first), so a peer with a broken comm path but a live
        process oscillates visibly instead of being silently trusted.
        """
        view = self.cfg.comm_view
        if view is None or not self.cfg.peer_ranks:
            return
        try:
            counts = view.suspicion()
        except Exception as exc:  # noqa: BLE001 — a comm-plane hiccup must not kill the tick
            self.last_error = exc
            return
        for peer, comm_rank in self.cfg.peer_ranks.items():
            if peer == self.cfg.node_id or peer not in self.cfg.peers:
                continue
            level = int(counts.get(int(comm_rank), 0))
            if level > self._comm_susp_seen.get(int(comm_rank), 0):
                self._comm_susp_seen[int(comm_rank)] = level
                if peer not in self._suspected:
                    self._suspected[peer] = now
                    self.suspicions += 1
                    _obs.record_cluster_suspicion(self.cfg.node_id, peer)

    def _confirmed_dead(self, now: float, rec: Optional[Member]) -> bool:
        return rec is None or now - rec.heartbeat >= self.cfg.confirm_after_s

    # ------------------------------------------------------------------ leading

    def _lead(self, now: float) -> None:
        cfg = self.cfg
        lease = self._lease
        if lease is None or lease.remaining(now) <= cfg.lease_ttl_s / 2.0:
            try:
                floor = max(int(getattr(self._engine, "_repl_epoch", 0)), 1)
                renewed = self._store.acquire_lease(cfg.node_id, cfg.lease_ttl_s, epoch_floor=floor)
            except CoordStoreError as exc:
                self.last_error = exc
                renewed = None
            if renewed is not None:
                if self._lease is not None and renewed.epoch == self._lease.epoch:
                    self.lease_renewals += 1
                    _obs.record_cluster_lease_renewal(cfg.node_id)
                self._lease = renewed
                self._align_epoch(renewed)
                return
            # renewal failed: still covered until OUR deadline passes — after
            # that, assume deposed (a peer may already hold a newer epoch)
            if lease is not None and not lease.expired(now):
                return
            self._step_down(now)

    def _align_epoch(self, lease: Lease) -> None:
        """Make the lease epoch and the engine's shipping epoch ONE fact.

        A promoted leader already ships at its lease epoch (promote() adopts
        it), but a cluster formed around an engine that was ALREADY primary
        ships at that engine's own epoch — lower than any fresh grant. Align
        on acquisition: bump the shipping epoch to the lease's and force a
        snapshot re-ship, so followers bootstrap into the leased epoch and
        their attach-time fences (at lease epoch) pass exactly this leader's
        frames. Renewals keep the epoch, so this is a no-op at steady state.
        """
        eng = self._engine
        if not self._engine_is_writable():
            return
        if int(getattr(eng, "_repl_epoch", 0)) == lease.epoch:
            return
        eng._repl_epoch = lease.epoch
        shipper = getattr(eng, "_shipper", None)
        if shipper is not None:
            shipper.epoch = lease.epoch
            shipper._need_snapshot = True  # followers re-bootstrap into the new epoch

    def _step_down(self, now: float) -> None:
        """Lease lost: stop writing, rejoin whatever lineage the store names."""
        self._transition("follower")
        self._lease = None
        self._next_attempt = now + self._jitter(self.cfg.election_backoff_s)
        try:
            current = self._store.read_lease()
        except CoordStoreError as exc:
            self.last_error = exc
            current = None
        if current is not None and not current.expired(now) and current.holder != self.cfg.node_id:
            self._attach_to(current)
            return
        # no successor yet: go read-only NOW anyway — writes accepted past our
        # deadline could race the successor's promotion (they would die at the
        # fence, but refusing them at the door is cheaper and honest); the
        # follower path re-attaches the moment a successor's lease lands
        if self.cfg.link_factory is not None and self._engine._repl_cfg is not None \
                and self._engine_is_writable():
            try:
                self._engine.demote(None)
            except MetricsTPUUserError as exc:
                self.last_error = exc
        self._following = None

    # ------------------------------------------------------------------ following

    def _follow(self, now: float, health: str, bootstrapped: bool, lag_seqs: int) -> None:
        cfg = self.cfg
        try:
            lease = self._store.read_lease()
        except CoordStoreError as exc:
            self.last_error = exc
            return
        if lease is not None and not lease.expired(now):
            if lease.holder == cfg.node_id:
                # we won the CAS (or a promote retry is pending): finish the job
                self._lease = lease
                self._try_promote(now, lease)
                return
            self._election_backoff = 0.0
            if self._engine_is_writable() or self._following != lease.holder:
                # a revived old leader rejoins the new lineage; a follower of a
                # dead leader re-attaches to the new one's link
                self._attach_to(lease)
            return
        # --- no live lease: election
        if not bootstrapped or health != "SERVING":
            return  # ineligible: never promote a gap/quarantine into leadership
        if now < self._next_attempt:
            return
        if not self._is_favourite(now, lag_seqs):
            # hold back one jittered round so the healthiest peer usually wins
            # uncontested; the CAS keeps safety if we both try anyway
            self._election_backoff = min(
                max(self._election_backoff * 2.0, cfg.election_backoff_s), cfg.backoff_cap_s
            )
            self._next_attempt = now + self._jitter(self._election_backoff)
            return
        applier = getattr(self._engine, "_applier", None)
        floor = (int(applier.epoch) + 1) if applier is not None \
            else max(int(getattr(self._engine, "_repl_epoch", 0)), 1)
        try:
            won = self._store.acquire_lease(cfg.node_id, cfg.lease_ttl_s, epoch_floor=floor)
        except CoordStoreError as exc:
            self.last_error = exc
            return
        if won is None:
            # a real lost election: we were eligible, favoured, and attempted
            # the CAS during an actual leader vacancy — another candidate won
            _obs.record_cluster_election_failed(cfg.node_id)
            self._next_attempt = now + self._jitter(cfg.election_backoff_s)
            return
        self._lease = won
        self._promote_backoff = 0.0
        self._try_promote(now, won)

    def _is_favourite(self, now: float, my_lag: int) -> bool:
        try:
            members = self._store.members()
        except CoordStoreError:
            return True  # can't rank: let the CAS arbitrate
        mine = (my_lag if my_lag >= 0 else float("inf"), self.cfg.node_id)
        for peer in self.cfg.peers:
            rec = members.get(peer)
            if rec is None or self._confirmed_dead(now, rec):
                continue
            if rec.role == "follower" and rec.bootstrapped and rec.health == "SERVING":
                peer_lag = rec.lag_seqs if rec.lag_seqs >= 0 else float("inf")
                if (peer_lag, rec.node_id) < mine:
                    return False
        return True

    # ------------------------------------------------------------------ promotion

    def _try_promote(self, now: float, lease: Lease) -> None:
        eng = self._engine
        if self._engine_is_writable():
            self._transition("leader")
            return
        cfg = self.cfg
        ship_cfg = None
        repl_cfg = eng._repl_cfg
        if cfg.link_factory is not None and repl_cfg is not None:
            links = [cfg.link_factory(cfg.node_id, peer) for peer in cfg.peers]
            ship_cfg = _dc_replace(
                repl_cfg,
                role="primary",
                transport=FanoutTransport(links),
                epoch=lease.epoch,
            )
        try:
            eng.promote(epoch=lease.epoch, ship=ship_cfg)
        except NotPromotableError as exc:
            # retryable by contract: the bootstrap snapshot has not landed yet.
            # Keep the lease (we renew while retrying) and back off jittered —
            # releasing it would just hand the same not-yet-promotable race to
            # a peer in no better position.
            self.last_error = exc
            self._promote_backoff = min(
                max(self._promote_backoff * 2.0, cfg.election_backoff_s), cfg.backoff_cap_s
            )
            self._next_attempt = now + self._jitter(self._promote_backoff)
            return
        except MetricsTPUUserError as exc:
            # non-retryable refusal (bad epoch, wrong role): release so a
            # healthier peer can win instead of us wedging the cluster
            self.last_error = exc
            self._lease = None
            try:
                self._store.release_lease(cfg.node_id)
            except CoordStoreError:
                pass
            return
        self.failovers += 1
        self._following = None
        self._transition("leader")
        _obs.record_cluster_failover(cfg.node_id)

    # ------------------------------------------------------------------ attachment

    def _attach_to(self, lease: Lease) -> None:
        """(Re)join ``lease.holder``'s lineage as a read-only follower, fencing
        our previous inbound link at the new epoch on the way out."""
        eng = self._engine
        cfg = self.cfg
        if cfg.link_factory is None or eng._repl_cfg is None:
            # externally wired (or repl-less) topology: role label only
            self._following = lease.holder
            self._transition("follower")
            return
        if not self._engine_is_writable() and self._following == lease.holder:
            return
        old_transport = eng._repl_cfg.transport
        follower_cfg = _dc_replace(
            eng._repl_cfg,
            role="follower",
            transport=cfg.link_factory(lease.holder, cfg.node_id),
            epoch=lease.epoch,
        )
        try:
            eng.demote(follower_cfg)
        except MetricsTPUUserError as exc:
            self.last_error = exc
            return
        try:
            # the deposed lineage dies at the boundary: late shipments from the
            # old leader into OUR old inbound link are fenced, not replayed
            old_transport.fence(lease.epoch)
        except Exception as exc:  # noqa: BLE001 — best effort; receive-side checks remain
            self.last_error = exc
        self._following = lease.holder
        self._transition("follower")

    # ------------------------------------------------------------------ plumbing

    def _jitter(self, base: float) -> float:
        return base * (1.0 + 0.5 * self._rng.random())

    def _transition(self, role: str) -> None:
        if role == self.role:
            return
        old, self.role = self.role, role
        _obs.set_cluster_role(self.cfg.node_id, role)
        hook = self.cfg.on_transition
        if hook is not None:
            try:
                hook(old, role)
            except Exception:  # noqa: BLE001 — an observer crash must not poison the tick
                pass

    def health_view(self) -> Dict[str, Any]:
        """The ``cluster`` section of ``engine.health()`` — node-local state
        only (never re-reads engine health: health() calls this)."""
        lease = self._lease
        now = self._store.now()
        return {
            "node_id": self.cfg.node_id,
            "role": self.role,
            "lease_epoch": lease.epoch if lease is not None else None,
            "lease_ttl_remaining_s": (
                max(0.0, lease.remaining(now)) if lease is not None else None
            ),
            "following": self._following,
            "suspected_peers": sorted(self._suspected),
            "failovers": self.failovers,
            "lease_renewals": self.lease_renewals,
            "suspicions": self.suspicions,
            "comm_lost_peers": self._comm_lost_peers(),
        }

    def _comm_lost_peers(self) -> List[str]:
        """Peer ids the comm plane's agreed live set currently excludes."""
        view = self.cfg.comm_view
        if view is None or not self.cfg.peer_ranks:
            return []
        try:
            lost = set(view.lost())
        except Exception:  # noqa: BLE001 — health must stay readable
            return []
        return sorted(p for p, r in self.cfg.peer_ranks.items() if int(r) in lost and p != self.cfg.node_id)
