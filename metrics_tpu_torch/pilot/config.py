"""PilotConfig — wiring and policy knobs for one autopilot controller (port of
``metrics_tpu/pilot/config.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from metrics_tpu_torch.cluster.errors import ClusterConfigError
from metrics_tpu_torch.cluster.store import CoordStore

__all__ = ["PilotConfig", "PILOT_LEASE"]

# the controller's dedicated named lease: same CAS-with-TTL machinery as the
# per-partition "p<N>" leases, so at most one live controller fleet-wide and
# failover needs no new mechanism
PILOT_LEASE = "pilot"


@dataclass(frozen=True)
class PilotConfig:
    """One :class:`~metrics_tpu_torch.pilot.loop.AutoPilot`'s configuration.

    Leadership / cadence (store-clock seconds, like every cluster knob):

    - ``lease_ttl_s``: TTL on the ``pilot`` named lease; renewed at half TTL.
    - ``tick_interval_s``: supervisor-thread cadence (lease upkeep).
    - ``evaluate_interval_s``: minimum store time between reconcile cycles —
      the lease renews every tick, decisions happen at most this often.

    Signal shaping:

    - ``ewma_alpha``: smoothing weight for every ingested signal (1.0 = raw).
    - ``min_observations``: a partition is not actionable until its signals
      were observed this many times — one noisy sample never moves tenants.
    - ``min_rate``: fleet below this aggregate write rate (events/s) is idle;
      an idle fleet has no hot spots, only noise.

    Hysteresis bands (flag at ``high``, unflag at ``low`` — the gap is what
    prevents flap; every band validates ``high > low``):

    - ``hot_ratio_high`` / ``hot_ratio_low``: a partition is HOT when its
      EWMA write rate exceeds ``high`` x the fleet mean, and stays flagged
      until it drops under ``low`` x the mean.
    - ``backlog_high`` / ``backlog_low``: queue-depth band (absolute
      requests) arming shard growth.
    - ``tier_occupancy_high`` / ``tier_occupancy_low``: hot-set fill
      fraction band arming a ``hot_capacity`` retune.

    Actuation bounds:

    - ``migration_budget`` per ``budget_window_s``: the actuator never starts
      more migrations than this inside one sliding window.
    - ``tenant_cooldown_s``: a tenant the pilot touched is untouchable for
      this long — the other half of anti-thrash.
    - ``max_actions_per_cycle``: hard per-cycle cap across all action kinds.
    - ``tier_retune_factor`` / ``tier_capacity_max``: hot-capacity growth
      step and ceiling (retunes only grow, like ``resize()``).
    - ``max_shards``: ceiling for planned shard growth.

    Kill switch: ``enabled=False`` builds an inert pilot (never acquires the
    lease, ticks are no-ops); runtime :meth:`~AutoPilot.pause` /
    :meth:`~AutoPilot.resume` keep the lease but stop actuation.
    ``dry_run=True`` plans and journals every cycle but executes nothing —
    migrations go through ``migrate_tenant(dry_run=True)`` so the journaled
    plan is the validated one.

    ``journal_directory`` pins the append-only CRC-framed decision log;
    ``None`` keeps decisions in memory only (tests).
    """

    node_id: str
    store: CoordStore
    enabled: bool = True
    dry_run: bool = False
    lease_ttl_s: float = 3.0
    tick_interval_s: float = 0.25
    evaluate_interval_s: float = 1.0
    ewma_alpha: float = 0.4
    min_observations: int = 2
    min_rate: float = 1.0
    hot_ratio_high: float = 2.0
    hot_ratio_low: float = 1.25
    backlog_high: float = 64.0
    backlog_low: float = 8.0
    tier_occupancy_high: float = 0.9
    tier_occupancy_low: float = 0.5
    tier_retune_factor: float = 2.0
    tier_capacity_max: int = 1 << 20
    max_shards: int = 64
    migration_budget: int = 4
    budget_window_s: float = 10.0
    tenant_cooldown_s: float = 30.0
    max_actions_per_cycle: int = 8
    journal_directory: Optional[str] = None

    def __post_init__(self) -> None:
        if not self.node_id:
            raise ClusterConfigError("PilotConfig.node_id must be non-empty")
        if self.store is None:
            raise ClusterConfigError("PilotConfig.store is required")
        for knob in ("lease_ttl_s", "tick_interval_s", "evaluate_interval_s",
                     "budget_window_s", "tenant_cooldown_s"):
            if getattr(self, knob) <= 0:
                raise ClusterConfigError(f"PilotConfig.{knob} must be > 0")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ClusterConfigError("PilotConfig.ewma_alpha must be in (0, 1]")
        if self.min_observations < 1:
            raise ClusterConfigError("PilotConfig.min_observations must be >= 1")
        if self.min_rate < 0:
            raise ClusterConfigError("PilotConfig.min_rate must be >= 0")
        for high, low in (("hot_ratio_high", "hot_ratio_low"),
                          ("backlog_high", "backlog_low"),
                          ("tier_occupancy_high", "tier_occupancy_low")):
            if getattr(self, high) <= getattr(self, low):
                raise ClusterConfigError(
                    f"PilotConfig.{high} must exceed {low} — the hysteresis gap "
                    "is what prevents flag/unflag flap"
                )
        if self.hot_ratio_low < 1.0:
            raise ClusterConfigError(
                "PilotConfig.hot_ratio_low must be >= 1.0 — a partition at or "
                "under the fleet mean is balanced by definition"
            )
        if self.tier_retune_factor <= 1.0:
            raise ClusterConfigError("PilotConfig.tier_retune_factor must be > 1.0")
        if self.tier_capacity_max < 1:
            raise ClusterConfigError("PilotConfig.tier_capacity_max must be >= 1")
        if self.max_shards < 1:
            raise ClusterConfigError("PilotConfig.max_shards must be >= 1")
        if self.migration_budget < 1:
            raise ClusterConfigError("PilotConfig.migration_budget must be >= 1")
        if self.max_actions_per_cycle < 1:
            raise ClusterConfigError("PilotConfig.max_actions_per_cycle must be >= 1")
