"""Poison-tenant quarantine: per-tenant breaker over request *failures*.

A tenant whose requests repeatedly fail (malformed shapes, dtype garbage —
anything that raises inside its own update) costs more than its own futures:
on the fused path each poison chunk pays a failed trace plus the eager retry.
After ``threshold`` consecutive failures the tenant is quarantined: its
submits fail fast with :class:`~metrics_tpu_torch.guard.errors.TenantQuarantined`
(state untouched, no retry cost) until a probation expires; then exactly one
probe request is admitted. A successful probe clears the tenant entirely; a
failed probe re-quarantines with probation grown by ``factor`` (capped), so a
persistently poisonous tenant converges to ~zero amortized cost.

Only *processing* failures count — quota/backpressure/deadline rejections
never touch the ledger (being rate-limited is not being poisonous). Memory is
bounded: only tenants with a live failure streak have an entry, and any
success deletes it.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Hashable, Optional

__all__ = ["ALLOW", "DENY", "PROBE", "TenantQuarantine"]

ALLOW, PROBE, DENY = "allow", "probe", "deny"


class _Entry:
    __slots__ = ("consecutive", "offenses", "quarantined_until", "probing", "held")

    def __init__(self) -> None:
        self.consecutive = 0
        self.offenses = 0  # quarantines served without an intervening success
        self.quarantined_until: Optional[float] = None
        self.probing = False
        self.held = False  # administrative hold (migration guard): only release() clears


class TenantQuarantine:
    def __init__(
        self,
        *,
        threshold: int = 5,
        probation_s: float = 1.0,
        probation_max_s: float = 300.0,
        probation_factor: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.threshold = int(threshold)
        self.probation_s = float(probation_s)
        self.probation_max_s = float(probation_max_s)
        self.probation_factor = float(probation_factor)
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: Dict[Hashable, _Entry] = {}

    def _probation(self, offenses: int) -> float:
        return min(
            self.probation_max_s,
            self.probation_s * self.probation_factor ** max(0, offenses - 1),
        )

    def check(self, key: Hashable) -> str:
        """Admission verdict for one submit: ALLOW, PROBE (admitted as the
        single half-open probe), or DENY (probation still running)."""
        if not self._entries:
            # hot path: no tenant has a live failure streak — one dict-empty
            # test, no lock (a racing first failure is seen on the next submit)
            return ALLOW
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry.quarantined_until is None:
                return ALLOW
            if self._clock() < entry.quarantined_until:
                return DENY
            if entry.probing:
                return DENY  # one probe at a time
            entry.probing = True
            return PROBE

    def record(self, key: Hashable, ok: bool) -> bool:
        """Record one processed request's outcome. Returns True if this
        failure (newly) quarantined the tenant."""
        if ok and not self._entries:
            return False  # hot path: nothing to forgive, no lock
        with self._lock:
            if ok:
                held = self._entries.get(key)
                if held is not None and held.held:
                    held.consecutive = 0  # a straggler's success never lifts a hold
                    return False
                self._entries.pop(key, None)  # forgiveness resets the ladder
                return False
            entry = self._entries.setdefault(key, _Entry())
            if entry.held:
                return False  # the hold already denies harder than any breaker would
            entry.consecutive += 1
            failed_probe = entry.probing
            entry.probing = False
            if failed_probe or entry.consecutive >= self.threshold:
                entry.offenses += 1
                entry.quarantined_until = self._clock() + self._probation(entry.offenses)
                entry.consecutive = 0
                return True
            return False

    def hold(self, key: Hashable) -> None:
        """Administratively quarantine ``key`` until :meth:`release` — no
        probation expiry, no probe. The partition plane holds a tenant on its
        migration *source* so stale-routed writes refuse loudly instead of
        silently re-creating evicted state at init."""
        with self._lock:
            entry = self._entries.setdefault(key, _Entry())
            entry.held = True
            entry.quarantined_until = float("inf")
            entry.probing = False

    def release(self, key: Hashable) -> None:
        """Lift an administrative hold (no-op for breaker-owned entries)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry.held:
                del self._entries[key]

    def abandon(self, key: Hashable) -> None:
        """The admitted probe never ran (e.g. the submit was rejected further
        down the pipeline) — free the probe slot so the tenant is not wedged."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                entry.probing = False

    def is_held(self, key: Hashable) -> bool:
        """True while an administrative :meth:`hold` is in force for ``key``.

        The migration drain barrier's second gate: a submit that passed
        admission BEFORE the hold landed re-checks here under the engine
        lock, so no row can slip in behind the source drain."""
        if not self._entries:
            return False  # same lock-free hot path as check()
        with self._lock:
            entry = self._entries.get(key)
            return entry is not None and entry.held

    def is_quarantined(self, key: Hashable) -> bool:
        with self._lock:
            entry = self._entries.get(key)
            return (
                entry is not None
                and entry.quarantined_until is not None
                and self._clock() < entry.quarantined_until
            )

    def active(self) -> Dict[Hashable, float]:
        """Currently-quarantined tenants → probation expiry (clock units)."""
        now = self._clock()
        with self._lock:
            return {
                key: entry.quarantined_until
                for key, entry in self._entries.items()
                if entry.quarantined_until is not None and now < entry.quarantined_until
            }
