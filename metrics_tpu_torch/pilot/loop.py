"""AutoPilot — the leader-run reconcile loop over fleet telemetry (port of
``metrics_tpu/pilot/loop.py``).

One controller fleet-wide, by construction: the loop acts only while holding
the dedicated ``pilot`` named lease (the same CAS-with-TTL machinery that
fences partition leaders — see :mod:`metrics_tpu_torch.cluster.store`), renewed at
half TTL. Every candidate host runs an AutoPilot; all but the lease holder
are warm standbys whose ticks cost one lease read. Kill the holder and a
standby wins the lease within one TTL — controller failover needs no new
mechanism and loses nothing but the in-memory EWMA warmup (the decision
journal and the fleet's telemetry both survive the hop).

A reconcile cycle is observe → decide → act → journal, in that order:

1. **Observe.** Pull the member table (one read the leader already pays),
   fold the piggybacked node snapshots into the fleet aggregator, fold the
   aggregator's live rows into the EWMA signal book. Stale nodes are
   excluded and named in the journal — never guessed at.
2. **Decide.** The hysteresis policy (:mod:`metrics_tpu_torch.pilot.policy`) turns
   readings into a bounded action plan plus decision docs explaining every
   flag edge and every refusal-to-act.
3. **Act.** The rate-limited actuator (:mod:`metrics_tpu_torch.pilot.actuator`)
   executes within migration budgets and tenant cooldowns; ``pause()`` (or
   ``dry_run``) stops actuation without giving up the lease, so an operator
   can freeze the fleet's controller without electing a new one.
4. **Journal.** The whole cycle — observations, decisions, actions, outcomes
   — lands as one CRC-framed record; actuator failures additionally dump a
   flight-recorder bundle. Post-mortem needs the journal alone.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Hashable, List, Optional, Tuple

from metrics_tpu_torch.cluster.errors import CoordStoreError
from metrics_tpu_torch.cluster.store import Lease
from metrics_tpu_torch.obs import fleet as _fleet
from metrics_tpu_torch.obs import instrument as _obs
from metrics_tpu_torch.part.pmap import partition_name
from metrics_tpu_torch.pilot.actuator import Actuator
from metrics_tpu_torch.pilot.config import PILOT_LEASE, PilotConfig
from metrics_tpu_torch.pilot.journal import DecisionJournal
from metrics_tpu_torch.pilot.policy import Policy
from metrics_tpu_torch.pilot.signals import SignalBook

__all__ = ["AutoPilot"]


class AutoPilot:
    """Supervise the fleet: hold the ``pilot`` lease, reconcile, journal.

    ``node`` is this host's :class:`~metrics_tpu_torch.part.PartitionedNode` — the
    pilot's window onto local leadership (which partitions' engines it may
    quarantine) and the executor surface for migrations/retunes. ``sharded``
    optionally names a :class:`~metrics_tpu_torch.shard.ShardedEngine` this host
    serves, enabling planned ``resize()`` growth. ``aggregator`` defaults to
    the process-global fleet aggregator; tests inject their own (with a
    manual clock) for deterministic staleness.
    """

    def __init__(
        self,
        node: Any,
        cfg: PilotConfig,
        *,
        aggregator: Optional[Any] = None,
        sharded: Optional[Any] = None,
        start: bool = True,
    ) -> None:
        self.cfg = cfg
        self._node = node
        self._store = cfg.store
        self._aggregator = aggregator if aggregator is not None else _fleet.AGGREGATOR
        self.signals = SignalBook(cfg.ewma_alpha)
        self.policy = Policy(cfg)
        self.actuator = Actuator(cfg, node, sharded=sharded)
        self.journal: Optional[DecisionJournal] = (
            DecisionJournal(cfg.journal_directory)
            if cfg.journal_directory is not None else None
        )
        self._sharded = sharded
        self._tick_lock = threading.Lock()
        self._lease: Optional[Lease] = None
        self._paused = False
        self._last_cycle = float("-inf")
        self.cycles = 0
        self.decisions = 0
        self.last_error: Optional[BaseException] = None
        # name -> pid for every partition this fleet serves (the part plane
        # stamps exactly these names on the engine series)
        self._partition_of: Dict[str, int] = {
            partition_name(pid): pid for pid in range(node.cfg.partitions)
        }
        _obs.set_pilot_paused(cfg.node_id, (not cfg.enabled) or self._paused)

        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start and cfg.enabled:
            self._thread = threading.Thread(
                target=self._run, name=f"metrics-tpu-torch-pilot-{cfg.node_id}", daemon=True
            )
            self._thread.start()

    # ------------------------------------------------------------------ lifecycle

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception as exc:  # noqa: BLE001 — the controller outlives any one bad cycle
                self.last_error = exc
            self._stop.wait(self.cfg.tick_interval_s)

    def close(self, *, release: bool = True) -> None:
        """Stop the controller; ``release=True`` concedes the pilot lease so a
        standby takes over immediately instead of waiting out the TTL."""
        self._stop.set()
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=5.0)
        if release and self._lease is not None:
            try:
                self._store.release_lease(self.cfg.node_id, name=PILOT_LEASE)
            except CoordStoreError:
                pass  # unreachable store: the TTL is the fallback
        self._lease = None

    # ------------------------------------------------------------------ kill switch

    def pause(self) -> None:
        """Freeze actuation without conceding the lease: cycles keep observing
        and journaling (with ``paused: true``) but no action executes."""
        self._paused = True
        _obs.set_pilot_paused(self.cfg.node_id, True)

    def resume(self) -> None:
        self._paused = False
        _obs.set_pilot_paused(self.cfg.node_id, (not self.cfg.enabled))

    @property
    def paused(self) -> bool:
        return self._paused

    @property
    def role(self) -> str:
        """"pilot" while holding the lease, else "standby"."""
        now = self._store.now()
        held = self._lease is not None and not self._lease.expired(now)
        return "pilot" if held else "standby"

    def health(self) -> Dict[str, Any]:
        """Controller state, one plain dict — the kill-switch surface."""
        now = self._store.now()
        lease = self._lease
        return {
            "node_id": self.cfg.node_id,
            "role": self.role,
            "enabled": self.cfg.enabled,
            "paused": self._paused,
            "dry_run": self.cfg.dry_run,
            "lease_epoch": lease.epoch if lease is not None else None,
            "lease_ttl_remaining_s": (
                max(0.0, lease.remaining(now)) if lease is not None else None
            ),
            "cycles": self.cycles,
            "decisions": self.decisions,
            "actions_executed": self.actuator.executed,
            "actions_refused": self.actuator.refused,
            "actions_failed": self.actuator.failures,
            "migration_budget_left": self.actuator.budget_left(now),
            "hot_partitions": list(self.policy.hot),
            "excluded_stale": sorted(self.signals.excluded_stale),
            "last_error": repr(self.last_error) if self.last_error else None,
        }

    # ------------------------------------------------------------------ the tick

    def tick(self) -> None:
        """One supervisor pass: lease upkeep, then (holder only, at most once
        per ``evaluate_interval_s``) a full reconcile cycle."""
        if not self.cfg.enabled:
            return
        with self._tick_lock:
            now = self._store.now()
            if not self._hold_lease(now):
                return
            if now - self._last_cycle < self.cfg.evaluate_interval_s:
                return
            self._last_cycle = now
            self._cycle(now)

    def _hold_lease(self, now: float) -> bool:
        lease = self._lease
        if lease is not None and not lease.expired(now) \
                and lease.remaining(now) > self.cfg.lease_ttl_s / 2.0:
            return True
        was_holder = lease is not None and not lease.expired(now)
        try:
            granted = self._store.acquire_lease(
                self.cfg.node_id, self.cfg.lease_ttl_s, name=PILOT_LEASE
            )
        except CoordStoreError as exc:
            self.last_error = exc
            granted = None
        if granted is not None:
            if not was_holder:
                _obs.record_pilot_lease_won(self.cfg.node_id, granted.epoch)
            self._lease = granted
            return True
        # renewal refused: still covered until OUR deadline passes — past it,
        # assume a standby already won a newer epoch
        if lease is not None and not lease.expired(now):
            return True
        if was_holder or lease is not None:
            _obs.record_pilot_lease_lost(self.cfg.node_id)
        self._lease = None
        return False

    # ------------------------------------------------------------------ the cycle

    def _observe(self) -> None:
        """Fold whatever telemetry has arrived into the signal book."""
        try:
            members = self._store.members()
        except CoordStoreError as exc:
            self.last_error = exc
            members = {}
        self._aggregator.ingest_members(members.values())
        try:
            # the holder's own registry, always fresh — its heartbeat snapshot
            # otherwise round-trips through the store it itself reads
            self._aggregator.ingest(_fleet.node_snapshot(self.cfg.node_id))
        except Exception:  # noqa: BLE001 — self-telemetry must not break the cycle
            pass
        self.signals.ingest(self._aggregator)

    def _tier_view(self) -> Dict[int, Tuple[str, int, Optional[float]]]:
        view: Dict[int, Tuple[str, int, Optional[float]]] = {}
        for pid in self._node.owned():
            eng = self._node.engine_for(pid)
            tier = getattr(eng, "_tier", None)
            if tier is None:
                continue
            eid = eng.telemetry.engine_id
            view[pid] = (eid, int(tier.cfg.hot_capacity), self.signals.tier_hot(eid))
        return view

    def _cycle(self, now: float) -> None:
        self._observe()
        self.cycles += 1
        readings = self.signals.readings()
        owned = self._node.owned()
        if self._paused:
            decisions: List[Dict[str, Any]] = [{"what": "paused"}]
            actions, outcomes = [], []
        else:
            tenants_of: Dict[int, List[Hashable]] = {
                pid: self._node.tenant_keys(pid) for pid in owned
            }
            shard_view = None
            if self._sharded is not None:
                shard_view = (len(self._sharded._engines), self.signals.backlog_total)
            decisions, actions = self.policy.plan(
                readings,
                partition_of=self._partition_of,
                owned=owned,
                tenants_of=tenants_of,
                tier_view=self._tier_view(),
                shard_view=shard_view,
            )
            outcomes = self.actuator.execute(actions, now)
        self.decisions += len(decisions)
        for d in decisions:
            _obs.record_pilot_decision(self.cfg.node_id, str(d.get("what", "unknown")))
        if self.journal is not None:
            self.journal.append({
                "t": now,
                "node": self.cfg.node_id,
                "lease_epoch": self._lease.epoch if self._lease is not None else None,
                "paused": self._paused,
                "dry_run": self.cfg.dry_run,
                "observations": self.signals.as_doc(),
                "decisions": decisions,
                "outcomes": outcomes,
            })
