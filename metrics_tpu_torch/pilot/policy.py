"""Reconcile policy: hysteresis-banded detection → a bounded action plan (port
of ``metrics_tpu/pilot/policy.py``; the same readings give the same plan).

Detection runs on ratios, not absolutes: a partition is HOT when its EWMA
write rate exceeds ``hot_ratio_high`` x the fleet mean, and stays flagged
until it drops under ``hot_ratio_low`` x the mean — the band gap is the
anti-flap guarantee (a partition oscillating around one threshold would
otherwise bounce tenants back and forth forever). The same banding arms tier
retunes (hot-set fill fraction) and shard growth (fleet backlog depth); both
of those actuations only ever GROW, mirroring ``ShardedEngine.resize()``'s
monotonicity, so a mis-tuned band costs capacity, never correctness.

Rebalancing is deliberately signal-light at the tenant grain: engine
telemetry attributes load to *partitions* (the ``partition=`` label), not to
individual tenants, so the planner spreads a hot partition's tenants
round-robin across the coldest partitions down to its fair share and lets
the next cycles re-observe — a few bounded moves per window plus hysteresis
converges without per-tenant rate accounting, and never overshoots by more
than one window's budget.

Every plan entry is a frozen dataclass with a ``describe()`` journal form;
the policy also returns *decision* docs for flag/unflag edges so the journal
explains inaction (a hot flag with no local leadership, a band not yet
crossed) as well as action.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Hashable, List, Optional, Sequence, Set, Tuple

from metrics_tpu_torch.pilot.config import PilotConfig
from metrics_tpu_torch.pilot.signals import Reading

__all__ = ["Action", "MigrateTenant", "RetuneTier", "ResizeShards", "Policy"]


@dataclass(frozen=True)
class Action:
    kind = "action"

    def describe(self) -> Dict[str, Any]:
        return {"kind": self.kind}


@dataclass(frozen=True)
class MigrateTenant(Action):
    key: Hashable
    src_pid: int
    dst_pid: int
    kind = "migrate_tenant"

    def describe(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "tenant": repr(self.key),
            "src_pid": self.src_pid,
            "dst_pid": self.dst_pid,
        }


@dataclass(frozen=True)
class RetuneTier(Action):
    pid: int
    hot_capacity: int
    kind = "retune_tier"

    def describe(self) -> Dict[str, Any]:
        return {"kind": self.kind, "pid": self.pid, "hot_capacity": self.hot_capacity}


@dataclass(frozen=True)
class ResizeShards(Action):
    new_shards: int
    kind = "resize_shards"

    def describe(self) -> Dict[str, Any]:
        return {"kind": self.kind, "new_shards": self.new_shards}


class Policy:
    """Hysteresis state + planner. One instance per pilot; not thread-safe
    (the loop serializes cycles under its tick lock)."""

    def __init__(self, cfg: PilotConfig) -> None:
        self.cfg = cfg
        self._hot: Set[str] = set()  # flagged partitions (hysteresis memory)
        self._tier_armed: Set[str] = set()  # engine ids past the occupancy band
        self._backlog_armed = False

    @property
    def hot(self) -> Tuple[str, ...]:
        return tuple(sorted(self._hot))

    # ------------------------------------------------------------------ planning

    def plan(
        self,
        readings: Dict[str, Reading],
        *,
        partition_of: Dict[str, int],
        owned: Sequence[int],
        tenants_of: Dict[int, List[Hashable]],
        tier_view: Dict[int, Tuple[str, int, Optional[float]]],
        shard_view: Optional[Tuple[int, float]] = None,
    ) -> Tuple[List[Dict[str, Any]], List[Action]]:
        """One reconcile pass: update flags, emit a bounded action list.

        - ``partition_of``: partition label -> pid (only labeled partitions
          are actionable).
        - ``owned``: pids this host currently leads — the pilot only moves
          tenants it can quarantine locally (source leadership is the
          migration precondition; a hot partition led elsewhere is journaled
          as out of reach, not guessed at).
        - ``tenants_of``: pid -> resident tenant keys for owned partitions.
        - ``tier_view``: pid -> (engine telemetry id, current hot_capacity,
          EWMA hot residents or None) for owned tiered partitions — residency
          comes from the signal book, capacity from the local engine.
        - ``shard_view``: (current shard count, backlog EWMA) when the pilot
          supervises a ShardedEngine, else None.
        """
        cfg = self.cfg
        decisions: List[Dict[str, Any]] = []
        actions: List[Action] = []

        mature = {
            p: r for p, r in readings.items()
            if r.observations >= cfg.min_observations and p in partition_of
        }
        total_rate = sum(r.rate for r in mature.values())
        mean_rate = total_rate / len(mature) if mature else 0.0

        # ---- hot-partition detection (ratio band over the fleet mean)
        if total_rate >= cfg.min_rate and mean_rate > 0:
            for part, r in sorted(mature.items()):
                ratio = r.rate / mean_rate
                if part in self._hot:
                    if ratio <= cfg.hot_ratio_low:
                        self._hot.discard(part)
                        decisions.append({
                            "what": "partition_cooled", "partition": part,
                            "ratio": round(ratio, 3), "band_low": cfg.hot_ratio_low,
                        })
                elif ratio >= cfg.hot_ratio_high:
                    self._hot.add(part)
                    decisions.append({
                        "what": "partition_hot", "partition": part,
                        "ratio": round(ratio, 3), "band_high": cfg.hot_ratio_high,
                        "rate": round(r.rate, 3), "fleet_mean": round(mean_rate, 3),
                    })
        elif self._hot and total_rate < cfg.min_rate:
            # idle fleet: nothing is hot relative to silence
            for part in sorted(self._hot):
                decisions.append({"what": "partition_cooled", "partition": part,
                                  "ratio": 0.0, "band_low": cfg.hot_ratio_low})
            self._hot.clear()

        # ---- rebalance plan: spread each owned hot partition to fair share
        owned_set = set(owned)
        cold_order = [
            partition_of[p]
            for p, _ in sorted(mature.items(), key=lambda kv: kv[1].rate)
            if p not in self._hot
        ]
        for part in sorted(self._hot):
            pid = partition_of[part]
            if pid not in owned_set:
                decisions.append({
                    "what": "hot_but_not_local", "partition": part,
                    "why": "this pilot does not lead the source partition; "
                           "its leader's pilot standby will act if it wins the lease",
                })
                continue
            if not cold_order:
                decisions.append({"what": "no_cold_destination", "partition": part})
                continue
            tenants = list(tenants_of.get(pid, ()))
            fair = max(1, len(tenants) // max(1, len(mature)))
            movable = tenants[fair:]
            if not movable:
                decisions.append({"what": "nothing_to_move", "partition": part,
                                  "tenants": len(tenants), "fair_share": fair})
                continue
            planned = 0
            for i, key in enumerate(movable):
                if len(actions) >= cfg.max_actions_per_cycle:
                    break
                actions.append(MigrateTenant(key, pid, cold_order[i % len(cold_order)]))
                planned += 1
            decisions.append({
                "what": "rebalance_planned", "partition": part,
                "tenants": len(tenants), "fair_share": fair,
                "planned_moves": planned,
            })

        # ---- tier retune: grow hot_capacity when the hot set runs full
        for pid, (eid, capacity, hot) in sorted(tier_view.items()):
            if hot is None or capacity <= 0:
                continue
            frac = hot / capacity
            if eid in self._tier_armed:
                if frac <= cfg.tier_occupancy_low:
                    self._tier_armed.discard(eid)
            elif frac >= cfg.tier_occupancy_high and capacity < cfg.tier_capacity_max:
                self._tier_armed.add(eid)
                new_cap = min(int(capacity * cfg.tier_retune_factor), cfg.tier_capacity_max)
                if new_cap > capacity and len(actions) < cfg.max_actions_per_cycle:
                    actions.append(RetuneTier(pid, new_cap))
                    decisions.append({
                        "what": "tier_retune", "pid": pid, "engine": eid,
                        "occupancy": round(frac, 3), "band_high": cfg.tier_occupancy_high,
                        "hot_capacity": capacity, "new_capacity": new_cap,
                    })

        # ---- shard growth: fleet backlog sustained past the band
        if shard_view is not None:
            current, backlog = shard_view
            if self._backlog_armed:
                if backlog <= cfg.backlog_low:
                    self._backlog_armed = False
            elif backlog >= cfg.backlog_high and current < cfg.max_shards:
                self._backlog_armed = True
                new_shards = min(current * 2, cfg.max_shards)
                if new_shards > current and len(actions) < cfg.max_actions_per_cycle:
                    actions.append(ResizeShards(new_shards))
                    decisions.append({
                        "what": "shard_growth", "backlog": round(backlog, 2),
                        "band_high": cfg.backlog_high,
                        "shards": current, "new_shards": new_shards,
                    })

        return decisions, actions[: cfg.max_actions_per_cycle]
