"""Tier plane — million-tenant residency-aware state tiering.

Turns the engine's stacked :class:`~metrics_tpu_torch.engine.stream.KeyedState` into
a three-tier slab:

- **hot** — tenants stay in the stacked device arrays exactly as before; the
  fused dispatch path is untouched and tiering costs nothing while the working
  set fits ``TierConfig.hot_capacity``.
- **warm** — demoted tenants live as per-tenant host-RAM entries (numpy rows
  captured from the slab); readmission copies the entry into a free
  slab row in place, well under a dispatch interval.
- **cold** — warm overflow spills to disk in the ``MTCKPT1`` container format
  and readmits through the same bit-identical restore path checkpoints use.

Demoted slots return to the slab's free-list (gated on a journaled retire
record so WAL replay can't alias rows), so device memory is bounded by the hot-set size
rather than the registered-tenant count. Eviction is guard-driven — idleness
is a token-bucket coldness clock, quarantined tenants evict first, pinned
tenants never — and runs on the dispatcher thread between micro-batches.
``submit()`` to a non-resident tenant promotes it transparently before the
micro-batch that needs the row.
"""

from metrics_tpu_torch.tier.coldstore import ColdStore
from metrics_tpu_torch.tier.config import TierConfig
from metrics_tpu_torch.tier.residency import (
    COLD,
    HOT,
    WARM,
    TierManager,
    capture_entry,
    peek_state,
    restore_entry,
)

__all__ = [
    "COLD",
    "ColdStore",
    "HOT",
    "TierConfig",
    "TierManager",
    "WARM",
    "capture_entry",
    "peek_state",
    "restore_entry",
]
