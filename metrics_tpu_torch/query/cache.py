"""Watermark-keyed result cache — validity by comparison, not by clock
(port of ``metrics_tpu/query/cache.py``).

A cached global state is the merge of partition rollups, each stamped with
the ``(epoch, seq)`` WAL watermark its slab snapshot was captured at. That
stamp makes validity EXACT, not heuristic: the cached merge is the true
global answer for as long as no contributing partition has journaled
anything past its watermark, and the instant one has, the stamp says so.
Revalidation is therefore a per-partition watermark *probe* (two ints over
the read path, servable by a follower) and an equality-shaped compare — no
slab fold, no merge tree, no TTL guessing.

The compare is generation-safe by construction: seq numbers are only
comparable within one primary lineage, and the epoch component changes on
every failover, so a promoted partition invalidates every cached result it
contributed to even if its new lineage happens to reuse seq numbers —
cached results can never mix watermark generations.

A probe seq BEHIND the cached stamp (same epoch) stays valid: it means the
probe landed on a replica lagging the one that served the rollup, and the
cached state is *fresher* evidence than the prober's own slab — the cache's
staleness stays bounded by the probing replica's own bounded-staleness
contract, never looser.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, Hashable, Optional, Tuple

from metrics_tpu_torch.query.report import QueryReport

__all__ = ["CachedGlobal", "WatermarkCache", "watermark_compatible"]


def watermark_compatible(cached: Tuple[int, int], probe: Tuple[int, int]) -> bool:
    """Is a cached stamp still valid against a freshly probed watermark?

    Valid iff the lineage is the SAME epoch and the probed seq has not
    advanced past the cached one. Any epoch difference — even "older" —
    invalidates: epochs are lineage identities, not magnitudes to order by.

    A cached stamp with ``seq < 0`` never validates: ``-1`` means the serving
    engine had journaled nothing (or has no durable plane), and for an
    un-journaled engine the stamp would never advance — "never changes" would
    silently mean "never invalidates" over state that does change.
    """
    return cached[1] >= 0 and probe[0] == cached[0] and probe[1] <= cached[1]


@dataclass(frozen=True)
class CachedGlobal:
    """One cached global merge: the state, its per-partition stamps, and the
    report describing the merge that produced it."""

    state: Dict[str, Any]
    watermarks: Dict[str, Tuple[int, int]]  # contributing partition -> stamp
    missing: Tuple[str, ...]  # partitions absent when the merge ran
    report: QueryReport
    tenants: int


class WatermarkCache:
    """Small thread-safe LRU of :class:`CachedGlobal` entries.

    Keys are whatever the caller derives from (metric fingerprint, window) —
    the cache itself only stores and evicts; validity is the caller's
    watermark compare, because validity needs fresh probes the cache cannot
    take."""

    def __init__(self, capacity: int = 32) -> None:
        if int(capacity) < 1:
            raise ValueError(f"`capacity` must be >= 1, got {capacity}")
        self._capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Hashable, CachedGlobal]" = OrderedDict()

    def get(self, key: Hashable) -> Optional[CachedGlobal]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
            return entry

    def put(self, key: Hashable, entry: CachedGlobal) -> None:
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self._capacity:
                self._entries.popitem(last=False)

    def invalidate(self, key: Optional[Hashable] = None) -> None:
        """Drop one entry (or all of them) — the ops escape hatch."""
        with self._lock:
            if key is None:
                self._entries.clear()
            else:
                self._entries.pop(key, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
