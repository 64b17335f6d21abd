"""Token-bucket admission quotas, per tenant.

A bucket holds up to ``burst`` tokens and refills at ``rate`` tokens/second
(continuously, from the injected clock — no refill thread). Admission takes
``rows`` tokens or fails; a failed take does not consume anything, so a tenant
over its rate degrades to exactly its sustained share instead of starving
itself further. ``rate=0`` blocks a tenant outright; ``rate=None`` (no quota
configured) admits everything.

:class:`TenantQuotas` maps tenants to buckets lazily — the set of tenants is
bounded by the engine's key capacity, so the map is too.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Hashable, Optional

__all__ = ["TenantQuotas", "TokenBucket"]


class TokenBucket:
    """Continuous-refill token bucket (thread-safe, injectable clock)."""

    def __init__(self, rate: float, burst: float, clock: Callable[[], float]) -> None:
        if rate < 0 or burst <= 0:
            raise ValueError(f"need rate >= 0 and burst > 0, got rate={rate} burst={burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._stamp = clock()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        elapsed = now - self._stamp
        if elapsed > 0:
            self._tokens = min(self.burst, self._tokens + elapsed * self.rate)
        self._stamp = now

    def try_take(self, n: float = 1.0) -> bool:
        """Take ``n`` tokens if available; a refused take consumes nothing."""
        with self._lock:
            self._refill(self._clock())
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def available(self) -> float:
        with self._lock:
            self._refill(self._clock())
            return self._tokens


class TenantQuotas:
    """Per-tenant token buckets with a default rate and per-tenant overrides."""

    def __init__(
        self,
        rows_per_s: Optional[float],
        burst_rows: Optional[float],
        overrides: Dict[Hashable, float],
        clock: Callable[[], float],
    ) -> None:
        self._rate = rows_per_s
        self._burst = burst_rows
        self._overrides = dict(overrides)
        self._clock = clock
        self._buckets: Dict[Hashable, TokenBucket] = {}
        self._lock = threading.Lock()
        # precomputed: quotas off must cost one attribute read on the submit hot path
        self.enabled = rows_per_s is not None or bool(self._overrides)

    def _bucket(self, key: Hashable) -> Optional[TokenBucket]:
        rate = self._overrides.get(key, self._rate)
        if rate is None:
            return None
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is None:
                # burst defaults to 2 seconds of rate (min 1 so a single-row
                # request is always *possible* under a tiny but nonzero rate)
                burst = self._burst if self._burst is not None else max(1.0, 2.0 * rate)
                bucket = self._buckets[key] = TokenBucket(rate, burst, self._clock)
            return bucket

    def admit(self, key: Hashable, rows: int) -> bool:
        """True if tenant ``key`` may submit ``rows`` more rows right now."""
        if not self.enabled:
            return True
        rate = self._overrides.get(key, self._rate)
        if rate is not None and rate <= 0 and self._burst is None:
            # rate 0 blocks outright — no initial-burst freebie. An EXPLICIT
            # burst with rate 0 is the other documented shape: a fixed
            # non-replenishing allowance.
            return False
        bucket = self._bucket(key)
        return True if bucket is None else bucket.try_take(float(rows))
