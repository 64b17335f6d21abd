"""Tier plane configuration: the knobs of the residency hierarchy."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError


@dataclass(frozen=True)
class TierConfig:
    """Residency policy for a :class:`~metrics_tpu_torch.engine.StreamingEngine`.

    ``hot_capacity`` bounds the number of tenants resident in the stacked
    device slab; the eviction pass (dispatcher thread, between micro-batches)
    demotes the coldest tenants down to this bound, so device memory scales with the
    hot-set size rather than the registered-tenant count. ``warm_capacity``
    bounds the host-RAM mirror — overflow spills to ``spill_directory`` in the
    ``MTCKPT1`` container format (``None`` disables the cold tier and lets the
    warm mirror grow unbounded). Idleness is a per-tenant last-active stamp:
    each dispatched request re-stamps its tenant, and seconds since the stamp
    (saturating at ``idle_demote_s``) is the coldness ordering — so a
    saturated reading certifies at least ``idle_demote_s`` seconds of
    silence. Quarantined tenants evict first; pinned tenants never.
    """

    hot_capacity: int = 1024
    warm_capacity: Optional[int] = None
    spill_directory: Optional[str] = None
    idle_demote_s: float = 30.0
    check_interval_s: float = 0.05
    durable: bool = True
    clock: Callable[[], float] = field(default=time.perf_counter, repr=False)

    def __post_init__(self) -> None:
        if self.hot_capacity < 1:
            raise MetricsTPUUserError(
                f"tier.hot_capacity must be >= 1, got {self.hot_capacity}"
            )
        if self.warm_capacity is not None and self.warm_capacity < 0:
            raise MetricsTPUUserError(
                f"tier.warm_capacity must be >= 0, got {self.warm_capacity}"
            )
        if self.warm_capacity is not None and self.spill_directory is None:
            raise MetricsTPUUserError(
                "tier.warm_capacity needs tier.spill_directory — a bounded warm "
                "mirror has to overflow somewhere"
            )
        if self.idle_demote_s <= 0:
            raise MetricsTPUUserError(
                f"tier.idle_demote_s must be > 0, got {self.idle_demote_s}"
            )
        if self.check_interval_s < 0:
            raise MetricsTPUUserError(
                f"tier.check_interval_s must be >= 0, got {self.check_interval_s}"
            )
