"""PartitionedNode — one host supervising a SET of partition leaderships (port
of ``metrics_tpu/part/node.py``).

The cluster plane's :class:`~metrics_tpu_torch.cluster.node.ClusterNode` runs one
lease, one engine, one lineage. This supervisor generalises that loop to P
keyspace partitions: one engine (own ``StreamingEngine`` WAL/ckpt lineage)
per partition, one *named* lease per partition, and the same three loops —
membership, failure detection, lead-or-elect — run once per tick with the
lease/election state tracked per partition:

1. **Membership.** One heartbeat record per node per interval (NOT per
   partition — P leases share one membership table), carrying a ``parts``
   payload: per-partition ``{bootstrapped, lag, role, health}``, the
   election's ranking input.
2. **Failure detection.** Identical to the cluster plane: a silent peer is
   suspected once per silence episode and confirmed dead past the threshold.
   One dead host does not produce one big failover — it produces ~P/N small,
   independent ones, each racing only that partition's named lease.
3. **Per-partition failover.** For every partition this node follows: read
   the named lease; if vacant, run the cluster plane's ranked election
   scoped to that partition (eligible = that partition's engine bootstrapped
   + SERVING; favourite = lowest lag over peers' ``parts`` records, ties by
   node id; non-favourites hold back one jittered round). The winner
   promotes that engine at exactly the won lease epoch — aligned the same
   way ``ClusterNode._align_epoch`` aligns the single lease — and ships the
   partition's new lineage over per-partition fan-out links. Losing a lease
   steps down exactly one partition; the node's other leaderships never
   notice.

At-most-one-writer holds *per partition* for the same boundary reason as the
cluster plane: partition ``p``'s lease epoch IS ``p``'s repl fencing epoch,
so a deposed owner's late shipments die at ``p``'s transport fence while its
still-held partitions keep shipping untouched (the JAX package's
``docs/source/partitions.md``).
"""

from __future__ import annotations

import random
import threading
from dataclasses import replace as _dc_replace
from typing import Any, Dict, List, Mapping, Optional, Tuple

from metrics_tpu_torch.cluster.errors import ClusterConfigError, CoordStoreError
from metrics_tpu_torch.cluster.store import Lease, Member
from metrics_tpu_torch.obs import instrument as _obs
from metrics_tpu_torch.obs.fleet import AGGREGATOR, node_snapshot
from metrics_tpu_torch.obs.registry import OBS as _OBS
from metrics_tpu_torch.part.config import PartConfig
from metrics_tpu_torch.part.pmap import PartitionMap
from metrics_tpu_torch.repl.errors import NotPromotableError
from metrics_tpu_torch.repl.transport import FanoutTransport
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

__all__ = ["PartitionedNode"]


class _PartSlot:
    """Per-partition supervisor state — the fields ClusterNode keeps once,
    kept once per partition."""

    __slots__ = (
        "pid",
        "name",
        "role",
        "lease",
        "following",
        "election_backoff",
        "next_attempt",
        "promote_backoff",
        "failovers",
        "lease_renewals",
    )

    def __init__(self, pid: int, name: str, role: str) -> None:
        self.pid = pid
        self.name = name
        self.role = role
        self.lease: Optional[Lease] = None
        self.following: Optional[str] = None
        self.election_backoff = 0.0
        self.next_attempt = float("-inf")
        self.promote_backoff = 0.0
        self.failovers = 0
        self.lease_renewals = 0


class PartitionedNode:
    """Supervise P partition engines' leaderships on one host.

    ``engines`` maps partition id → that partition's
    :class:`~metrics_tpu_torch.engine.StreamingEngine` on THIS host (every host
    runs one engine per partition; which hosts lead which partitions is
    decided by the named-lease CAS). ``start=True`` runs a supervisor thread
    at ``cfg.tick_interval_s``; ``start=False`` leaves ticking to the caller
    (deterministic tests drive :meth:`tick` under a manual store clock).
    """

    def __init__(
        self,
        engines: Mapping[int, Any],
        cfg: PartConfig,
        *,
        pmap: Optional[PartitionMap] = None,
        start: bool = True,
    ) -> None:
        if set(engines) != set(range(cfg.partitions)):
            raise ClusterConfigError(
                f"engines must cover exactly partitions 0..{cfg.partitions - 1}, "
                f"got {sorted(engines)}"
            )
        for eng in engines.values():
            if getattr(eng, "_cluster", None) is not None:
                raise ClusterConfigError("engine already supervised by another node")
        self._engines: Dict[int, Any] = dict(engines)
        self.cfg = cfg
        self._store = cfg.store
        self.pmap = pmap if pmap is not None else PartitionMap(
            cfg.partitions,
            vnodes=cfg.vnodes,
            seed=cfg.seed,
            directory=cfg.manifest_directory,
        )
        if self.pmap.partitions != cfg.partitions:
            raise ClusterConfigError(
                f"pmap has {self.pmap.partitions} partitions, cfg says {cfg.partitions}"
            )
        self._rng = random.Random(
            cfg.rng_seed if cfg.rng_seed is not None else hash(cfg.node_id)
        )
        self._tick_lock = threading.Lock()
        self._slots: Dict[int, _PartSlot] = {}
        for pid in range(cfg.partitions):
            role = "leader" if self._engine_is_writable(pid) else "follower"
            slot = _PartSlot(pid, self.pmap.name_of(pid), role)
            self._slots[pid] = slot
            self._engines[pid]._cluster = self
            # hot-spot attribution without client-side joins: the adopted
            # engine's write-rate/backlog/latency series all carry its
            # partition name from here on (the shard plane's shard= parity)
            telemetry = getattr(self._engines[pid], "telemetry", None)
            if telemetry is not None:
                telemetry.add_labels(partition=slot.name)
            _obs.set_part_role(cfg.node_id, slot.name, role)

        self.suspicions = 0
        self.last_error: Optional[BaseException] = None
        self._suspected: Dict[str, float] = {}  # peer -> suspected-since (store time)
        self._last_heartbeat = float("-inf")

        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._run, name=f"metrics-tpu-torch-part-{cfg.node_id}", daemon=True
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
        """Stop supervising. ``release=True`` steps every held lease down so
        peers can take the partitions over immediately instead of waiting out
        the TTLs."""
        self._stop.set()
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=5.0)
        if release:
            for slot in self._slots.values():
                if slot.role == "leader":
                    try:
                        self._store.release_lease(self.cfg.node_id, name=slot.name)
                    except CoordStoreError:
                        pass  # unreachable store: the TTL is the fallback
        for eng in self._engines.values():
            if getattr(eng, "_cluster", None) is self:
                eng._cluster = None

    # ------------------------------------------------------------------ engine view

    def engine_for(self, pid: int) -> Any:
        return self._engines[pid]

    def owned(self) -> Tuple[int, ...]:
        """Partition ids this node currently leads."""
        return tuple(pid for pid, s in self._slots.items() if s.role == "leader")

    def _engine_is_writable(self, pid: int) -> bool:
        return not getattr(self._engines[pid], "_repl_follower", False)

    def _engine_view(self, pid: int) -> Tuple[str, bool, int]:
        """(health state, bootstrapped, lag_seqs) for one partition's engine."""
        eng = self._engines[pid]
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
        """One supervisor pass over every partition: heartbeat, detect, then
        lead-or-elect per partition. Store failures are absorbed and treated
        as lease loss, never success."""
        with self._tick_lock:
            now = self._store.now()
            views = {pid: self._engine_view(pid) for pid in self._slots}
            self._publish_heartbeat(now, views)
            self._detect_failures(now)
            for pid, slot in self._slots.items():
                if slot.role == "leader":
                    self._lead_part(now, slot)
                else:
                    self._follow_part(now, slot, views[pid])

    # ------------------------------------------------------------------ membership

    def _publish_heartbeat(self, now: float, views: Dict[int, Tuple[str, bool, int]]) -> None:
        if now - self._last_heartbeat < self.cfg.heartbeat_interval_s:
            return
        parts = {
            self._slots[pid].name: {
                "bootstrapped": bool(views[pid][1]),
                "lag": int(views[pid][2]),
                "role": self._slots[pid].role,
                "health": views[pid][0],
            }
            for pid in self._slots
        }
        healths = [v[0] for v in views.values()]
        worst = next((h for h in healths if h != "SERVING"), "SERVING")
        lags = [v[2] for v in views.values()]
        fleet = None
        if _OBS.enabled:
            try:
                # piggyback this node's telemetry snapshot on the membership
                # record it already publishes (cluster-plane parity) — the
                # autopilot reads these off the member table to observe
                fleet = node_snapshot(self.cfg.node_id)
            except Exception:  # noqa: BLE001 — telemetry must not break membership
                fleet = None
        member = Member(
            node_id=self.cfg.node_id,
            role="leader" if any(s.role == "leader" for s in self._slots.values()) else "follower",
            health=worst,
            bootstrapped=all(v[1] for v in views.values()),
            lag_seqs=-1 if any(l < 0 for l in lags) else max(lags, default=0),
            heartbeat=now,
            parts=parts,
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
        if _OBS.enabled and any(s.role == "leader" for s in self._slots.values()):
            # any partition leader is a fleet merge point (cluster-plane
            # parity): fold peers' piggybacked snapshots off the member table
            # this pass already fetched — zero extra store IO
            AGGREGATOR.ingest_members(members.values())
        for peer in self.cfg.peers:
            rec = members.get(peer)
            silent = now - rec.heartbeat if rec is not None else float("inf")
            if rec is not None and silent >= self.cfg.suspect_after_s:
                if peer not in self._suspected:
                    # suspicion counts once per silence episode, on the edge
                    self._suspected[peer] = now
                    self.suspicions += 1
            elif rec is not None:
                self._suspected.pop(peer, None)

    def _confirmed_dead(self, now: float, rec: Optional[Member]) -> bool:
        return rec is None or now - rec.heartbeat >= self.cfg.confirm_after_s

    # ------------------------------------------------------------------ leading

    def _lease_floor(self, slot: _PartSlot) -> int:
        eng = self._engines[slot.pid]
        return max(
            int(getattr(eng, "_repl_epoch", 0)), 1, self.pmap.epoch_floor(slot.pid)
        )

    def _lead_part(self, now: float, slot: _PartSlot) -> None:
        cfg = self.cfg
        lease = slot.lease
        if lease is None or lease.remaining(now) <= cfg.lease_ttl_s / 2.0:
            try:
                renewed = self._store.acquire_lease(
                    cfg.node_id,
                    cfg.lease_ttl_s,
                    epoch_floor=self._lease_floor(slot),
                    name=slot.name,
                )
            except CoordStoreError as exc:
                self.last_error = exc
                renewed = None
            if renewed is not None:
                if slot.lease is not None and renewed.epoch == slot.lease.epoch:
                    slot.lease_renewals += 1
                slot.lease = renewed
                self._align_epoch(slot, renewed)
                return
            # renewal failed: still covered until OUR deadline passes — after
            # that, assume deposed (a peer may already hold a newer epoch)
            if lease is not None and not lease.expired(now):
                return
            self._step_down_part(now, slot)

    def _align_epoch(self, slot: _PartSlot, lease: Lease) -> None:
        """Make this partition's lease epoch and shipping epoch ONE fact —
        the per-partition twin of ``ClusterNode._align_epoch``."""
        eng = self._engines[slot.pid]
        if not self._engine_is_writable(slot.pid):
            return
        if int(getattr(eng, "_repl_epoch", 0)) == lease.epoch:
            return
        eng._repl_epoch = lease.epoch
        shipper = getattr(eng, "_shipper", None)
        if shipper is not None:
            shipper.epoch = lease.epoch
            shipper._need_snapshot = True  # followers re-bootstrap into the new epoch

    def _step_down_part(self, now: float, slot: _PartSlot) -> None:
        """Lease lost for ONE partition: stop writing it, rejoin whatever
        lineage the store names — the node's other partitions never notice."""
        self._transition(slot, "follower")
        slot.lease = None
        slot.next_attempt = now + self._jitter(self.cfg.election_backoff_s)
        _obs.record_part_lease_lost(self.cfg.node_id, slot.name)
        try:
            current = self._store.read_lease(slot.name)
        except CoordStoreError as exc:
            self.last_error = exc
            current = None
        if current is not None and not current.expired(now) and current.holder != self.cfg.node_id:
            self._attach_part(slot, current)
            return
        # no successor yet: go read-only NOW anyway — writes accepted past our
        # deadline could race the successor's promotion (they would die at the
        # fence, but refusing them at the door is cheaper and honest)
        eng = self._engines[slot.pid]
        if self.cfg.link_factory is not None and eng._repl_cfg is not None \
                and self._engine_is_writable(slot.pid):
            try:
                eng.demote(None)
            except MetricsTPUUserError as exc:
                self.last_error = exc
        slot.following = None

    # ------------------------------------------------------------------ following

    def _follow_part(self, now: float, slot: _PartSlot, view: Tuple[str, bool, int]) -> None:
        cfg = self.cfg
        health, bootstrapped, lag_seqs = view
        try:
            lease = self._store.read_lease(slot.name)
        except CoordStoreError as exc:
            self.last_error = exc
            return
        if lease is not None and not lease.expired(now):
            if lease.holder == cfg.node_id:
                # we won the CAS (or a promote retry is pending): finish the job
                slot.lease = lease
                self._try_promote_part(now, slot, lease)
                return
            slot.election_backoff = 0.0
            if self._engine_is_writable(slot.pid) or slot.following != lease.holder:
                # a revived old owner rejoins the new lineage; a follower of a
                # dead owner re-attaches to the new one's link
                self._attach_part(slot, lease)
            return
        # --- no live lease for this partition: election
        if not bootstrapped or health != "SERVING":
            return  # ineligible: never promote a gap/quarantine into leadership
        if now < slot.next_attempt:
            return
        if not self._is_favourite(now, slot, lag_seqs):
            # hold back one jittered round so the healthiest peer usually wins
            # uncontested; the CAS keeps safety if we both try anyway
            slot.election_backoff = min(
                max(slot.election_backoff * 2.0, cfg.election_backoff_s), cfg.backoff_cap_s
            )
            slot.next_attempt = now + self._jitter(slot.election_backoff)
            return
        applier = getattr(self._engines[slot.pid], "_applier", None)
        floor = (int(applier.epoch) + 1) if applier is not None else self._lease_floor(slot)
        floor = max(floor, self.pmap.epoch_floor(slot.pid))
        try:
            won = self._store.acquire_lease(
                cfg.node_id, cfg.lease_ttl_s, epoch_floor=floor, name=slot.name
            )
        except CoordStoreError as exc:
            self.last_error = exc
            return
        if won is None:
            # a real lost election for this partition: another candidate won
            slot.next_attempt = now + self._jitter(cfg.election_backoff_s)
            return
        slot.lease = won
        slot.promote_backoff = 0.0
        self._try_promote_part(now, slot, won)

    def _is_favourite(self, now: float, slot: _PartSlot, my_lag: int) -> bool:
        """Rank THIS partition's candidacy over peers' per-partition records."""
        try:
            members = self._store.members()
        except CoordStoreError:
            return True  # can't rank: let the CAS arbitrate
        mine = (my_lag if my_lag >= 0 else float("inf"), self.cfg.node_id)
        for peer in self.cfg.peers:
            rec = members.get(peer)
            if rec is None or self._confirmed_dead(now, rec):
                continue
            part = (rec.parts or {}).get(slot.name)
            if part is None:
                continue  # peer doesn't supervise this partition
            if (
                part.get("role") == "follower"
                and part.get("bootstrapped")
                and part.get("health", rec.health) == "SERVING"
            ):
                peer_lag = int(part.get("lag", -1))
                peer_rank = (peer_lag if peer_lag >= 0 else float("inf"), rec.node_id)
                if peer_rank < mine:
                    return False
        return True

    # ------------------------------------------------------------------ promotion

    def _try_promote_part(self, now: float, slot: _PartSlot, lease: Lease) -> None:
        eng = self._engines[slot.pid]
        if self._engine_is_writable(slot.pid):
            self._transition(slot, "leader")
            return
        cfg = self.cfg
        ship_cfg = None
        repl_cfg = eng._repl_cfg
        if cfg.link_factory is not None and repl_cfg is not None:
            links = [cfg.link_factory(cfg.node_id, peer, slot.name) for peer in cfg.peers]
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
            # Keep the lease (we renew while retrying) and back off jittered.
            self.last_error = exc
            slot.promote_backoff = min(
                max(slot.promote_backoff * 2.0, cfg.election_backoff_s), cfg.backoff_cap_s
            )
            slot.next_attempt = now + self._jitter(slot.promote_backoff)
            return
        except MetricsTPUUserError as exc:
            # non-retryable refusal: release so a healthier peer can win
            # instead of us wedging the partition
            self.last_error = exc
            slot.lease = None
            try:
                self._store.release_lease(cfg.node_id, name=slot.name)
            except CoordStoreError:
                pass
            return
        slot.failovers += 1
        slot.following = None
        self._transition(slot, "leader")
        _obs.record_part_failover(cfg.node_id, slot.name)

    # ------------------------------------------------------------------ attachment

    def _attach_part(self, slot: _PartSlot, lease: Lease) -> None:
        """(Re)join ``lease.holder``'s lineage for ONE partition, fencing our
        previous inbound link for that partition only."""
        eng = self._engines[slot.pid]
        cfg = self.cfg
        if cfg.link_factory is None or eng._repl_cfg is None:
            # externally wired (or repl-less) topology: role label only
            slot.following = lease.holder
            self._transition(slot, "follower")
            return
        if not self._engine_is_writable(slot.pid) and slot.following == lease.holder:
            return
        old_transport = eng._repl_cfg.transport
        follower_cfg = _dc_replace(
            eng._repl_cfg,
            role="follower",
            transport=cfg.link_factory(lease.holder, cfg.node_id, slot.name),
            epoch=lease.epoch,
        )
        try:
            eng.demote(follower_cfg)
        except MetricsTPUUserError as exc:
            self.last_error = exc
            return
        try:
            # the deposed lineage dies at the boundary FOR THIS PARTITION: late
            # shipments into our old inbound p-link are fenced, not replayed
            old_transport.fence(lease.epoch)
        except Exception as exc:  # noqa: BLE001 — best effort; receive-side checks remain
            self.last_error = exc
        slot.following = lease.holder
        self._transition(slot, "follower")

    # ------------------------------------------------------------------ plumbing

    def _jitter(self, base: float) -> float:
        return base * (1.0 + 0.5 * self._rng.random())

    def _transition(self, slot: _PartSlot, role: str) -> None:
        if role == slot.role:
            return
        old, slot.role = slot.role, role
        _obs.set_part_role(self.cfg.node_id, slot.name, role)
        hook = self.cfg.on_transition
        if hook is not None:
            try:
                hook(slot.name, old, role)
            except Exception:  # noqa: BLE001 — an observer crash must not poison the tick
                pass

    @property
    def failovers(self) -> int:
        return sum(s.failovers for s in self._slots.values())

    @property
    def lease_renewals(self) -> int:
        return sum(s.lease_renewals for s in self._slots.values())

    def health_view(self) -> Dict[str, Any]:
        """Node-local partition-plane state, one plain dict."""
        now = self._store.now()
        parts: Dict[str, Any] = {}
        for pid, slot in sorted(self._slots.items()):
            lease = slot.lease
            parts[slot.name] = {
                "role": slot.role,
                "lease_epoch": lease.epoch if lease is not None else None,
                "lease_ttl_remaining_s": (
                    max(0.0, lease.remaining(now)) if lease is not None else None
                ),
                "following": slot.following,
                "failovers": slot.failovers,
            }
        return {
            "node_id": self.cfg.node_id,
            "partitions": parts,
            "owned": sorted(self.owned()),
            "suspected_peers": sorted(self._suspected),
            "failovers": self.failovers,
            "lease_renewals": self.lease_renewals,
            "suspicions": self.suspicions,
        }

    def tenant_keys(self, pid: int) -> List[Any]:
        """Every tenant partition ``pid``'s engine currently knows (slab +
        tiered) — migration/sweep introspection."""
        eng = self._engines[pid]
        keys = list(eng._keyed.keys)
        tier = getattr(eng, "_tier", None)
        if tier is not None:
            keys.extend(tier.keys())
        return keys
