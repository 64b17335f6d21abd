"""Autopilot plane — the controller that makes the other planes self-driving
(port of ``metrics_tpu/pilot``).

Twelve planes of mechanism exist below this one: fleet telemetry with
staleness stamps (obs), live bit-identical tenant migration between
partition leaders (part), live shard growth (shard), and tier residency
series + retunable hot capacity (tier). This plane closes the loop: a
reconcile controller that runs only on the holder of the dedicated ``pilot``
named lease, reads the telemetry the leader already receives, detects hot
partitions via hysteresis bands over EWMA'd signals, and executes a bounded,
budgeted, cooled-down action plan — every cycle journaled to an append-only
CRC-framed decision log::

    from metrics_tpu_torch.pilot import AutoPilot, PilotConfig

    pilot = AutoPilot(part_node, PilotConfig(
        node_id="a", store=store, journal_directory="/shared/pilot"))
    pilot.health()          # role, lease, budget, hot set, kill-switch state
    pilot.pause()           # freeze actuation; keep the lease; keep observing
    pilot.resume()

Safety is layered: ``PilotConfig.enabled=False`` builds an inert pilot;
``pause()``/``resume()`` gate actuation at runtime; ``dry_run=True`` plans
and journals validated migrations (``migrate_tenant(dry_run=True)``) without
moving anything; and the actuator's per-window migration budget + per-tenant
cooldown bound the blast radius of any mis-detection. See the JAX
package's ``docs/source/autopilot.md`` for the signal model and the post-mortem
walkthrough.
"""

from metrics_tpu_torch.pilot.actuator import Actuator
from metrics_tpu_torch.pilot.config import PILOT_LEASE, PilotConfig
from metrics_tpu_torch.pilot.journal import DecisionJournal, read_journal
from metrics_tpu_torch.pilot.loop import AutoPilot
from metrics_tpu_torch.pilot.policy import (
    Action,
    MigrateTenant,
    Policy,
    ResizeShards,
    RetuneTier,
)
from metrics_tpu_torch.pilot.signals import Reading, SignalBook

__all__ = [
    "Action",
    "Actuator",
    "AutoPilot",
    "DecisionJournal",
    "MigrateTenant",
    "PILOT_LEASE",
    "PilotConfig",
    "Policy",
    "Reading",
    "ResizeShards",
    "RetuneTier",
    "SignalBook",
    "read_journal",
]
