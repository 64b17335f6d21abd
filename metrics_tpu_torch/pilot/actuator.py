"""Rate-limited actuator: a bounded plan → executed (or refused) actions
(port of ``metrics_tpu/pilot/actuator.py``).

Every action runs through three gates before it touches anything:

1. **Budget.** At most ``migration_budget`` migrations start inside any
   sliding ``budget_window_s`` window — a mis-detecting policy can degrade
   the fleet by at most one window's worth of quarantine holds before the
   budget refuses it.
2. **Cooldown.** A tenant the pilot touched (even unsuccessfully) is
   untouchable for ``tenant_cooldown_s`` — the pair of a hysteresis band on
   detection and a cooldown on actuation is what makes the loop convergent
   instead of oscillatory.
3. **Locality.** Migrations need both partition leaders' engines writable on
   THIS host (``migrate_tenant``'s contract); an action whose engines are led
   elsewhere is refused as ``not_local``, journaled, and left for the host
   that can actually quarantine the source.

``dry_run`` routes migrations through ``migrate_tenant(dry_run=True)`` so
the journaled outcome carries the *validated* plan (leases, quarantine,
epoch floor) rather than a guess. An action that raises is an actuator
failure edge: counted, flight-dumped (``pilot_action_failed`` bundle), and
reported in the outcome — the cycle continues, the loop survives.
"""

from __future__ import annotations

from collections import deque
from dataclasses import replace as _dc_replace
from typing import Any, Dict, Hashable, List, Optional, Sequence

from metrics_tpu_torch.obs import instrument as _obs
from metrics_tpu_torch.part.migrate import migrate_tenant
from metrics_tpu_torch.pilot.config import PilotConfig
from metrics_tpu_torch.pilot.policy import Action, MigrateTenant, ResizeShards, RetuneTier
from metrics_tpu_torch.shard.ring import stable_key_bytes

__all__ = ["Actuator"]


class Actuator:
    """Execute a policy plan against one host's engines, within bounds."""

    def __init__(self, cfg: PilotConfig, node: Any, sharded: Optional[Any] = None) -> None:
        self.cfg = cfg
        self._node = node  # PartitionedNode: pmap + engines + leadership truth
        self._sharded = sharded
        self._window: deque = deque()  # migration start stamps (store time)
        self._cooldown: Dict[str, float] = {}  # stable tenant key hex -> stamp
        self.executed = 0
        self.refused = 0
        self.failures = 0

    # ------------------------------------------------------------------ gates

    def budget_left(self, now: float) -> int:
        while self._window and now - self._window[0] > self.cfg.budget_window_s:
            self._window.popleft()
        return max(0, self.cfg.migration_budget - len(self._window))

    def _cooling(self, key: Hashable, now: float) -> bool:
        stamp = self._cooldown.get(stable_key_bytes(key).hex())
        return stamp is not None and now - stamp < self.cfg.tenant_cooldown_s

    def _writable(self, pid: int) -> Optional[Any]:
        eng = self._node.engine_for(pid)
        return None if getattr(eng, "_repl_follower", False) else eng

    # ------------------------------------------------------------------ execute

    def execute(self, actions: Sequence[Action], now: float) -> List[Dict[str, Any]]:
        """Run each action through the gates; one outcome doc per action."""
        outcomes: List[Dict[str, Any]] = []
        for action in actions[: self.cfg.max_actions_per_cycle]:
            doc = action.describe()
            try:
                if isinstance(action, MigrateTenant):
                    doc.update(self._migrate(action, now))
                elif isinstance(action, RetuneTier):
                    doc.update(self._retune(action))
                elif isinstance(action, ResizeShards):
                    doc.update(self._resize(action))
                else:
                    doc["outcome"] = "unknown_action"
            except Exception as exc:  # noqa: BLE001 — one bad action must not kill the loop
                self.failures += 1
                doc["outcome"] = "error"
                doc["error"] = f"{type(exc).__name__}: {exc}"
                _obs.record_pilot_action_failed(self.cfg.node_id, action.kind)
            if doc["outcome"] in ("refused_budget", "refused_cooldown", "not_local",
                                  "no_tier", "no_sharded"):
                self.refused += 1
            outcomes.append(doc)
        return outcomes

    def _migrate(self, action: MigrateTenant, now: float) -> Dict[str, Any]:
        if self._cooling(action.key, now):
            return {"outcome": "refused_cooldown",
                    "cooldown_s": self.cfg.tenant_cooldown_s}
        if self.budget_left(now) <= 0:
            return {"outcome": "refused_budget",
                    "budget": self.cfg.migration_budget,
                    "window_s": self.cfg.budget_window_s}
        src = self._writable(action.src_pid)
        dst = self._writable(action.dst_pid)
        if src is None or dst is None:
            return {"outcome": "not_local",
                    "src_writable": src is not None, "dst_writable": dst is not None}
        # the budget charges attempts, not successes: an error storm must be
        # rate-limited exactly like a success storm
        self._window.append(now)
        self._cooldown[stable_key_bytes(action.key).hex()] = now
        if self.cfg.dry_run:
            plan = migrate_tenant(
                action.key, action.dst_pid, pmap=self._node.pmap,
                src_engine=src, dst_engine=dst, node_id=self.cfg.node_id,
                dry_run=True,
            )
            return {"outcome": "dry_run", "plan": plan}
        moved = migrate_tenant(
            action.key, action.dst_pid, pmap=self._node.pmap,
            src_engine=src, dst_engine=dst, node_id=self.cfg.node_id,
        )
        if moved:
            self.executed += 1
            _obs.record_pilot_migration(self.cfg.node_id)
        return {"outcome": "ok" if moved else "noop"}

    def _retune(self, action: RetuneTier) -> Dict[str, Any]:
        eng = self._node.engine_for(action.pid)
        tier = getattr(eng, "_tier", None)
        if tier is None:
            return {"outcome": "no_tier"}
        old = tier.cfg.hot_capacity
        if self.cfg.dry_run:
            return {"outcome": "dry_run", "plan": {"hot_capacity": old,
                                                   "new_capacity": action.hot_capacity}}
        # TierConfig is frozen; the manager reads .cfg on every pass, so a
        # replace-and-assign takes effect at the next tier sweep. No slab row
        # moves here: a larger cap only lets later admissions stay hot, and
        # one that outgrows the slab grows it as any admission does (on the
        # engine's stream, its graphs recaptured against the new slab)
        tier.cfg = _dc_replace(tier.cfg, hot_capacity=int(action.hot_capacity))
        self.executed += 1
        return {"outcome": "ok", "was": old}

    def _resize(self, action: ResizeShards) -> Dict[str, Any]:
        if self._sharded is None:
            return {"outcome": "no_sharded"}
        if self.cfg.dry_run:
            return {"outcome": "dry_run", "plan": {"new_shards": action.new_shards}}
        moved = self._sharded.resize(action.new_shards)
        self.executed += 1
        return {"outcome": "ok", "tenants_moved": len(moved)}
