"""Signal extraction: fleet telemetry snapshots → EWMA'd per-target readings
(port of ``metrics_tpu/pilot/signals.py``).

The pilot never talks to engines to observe — it reads the same piggybacked
:func:`~metrics_tpu_torch.obs.fleet.node_snapshot` documents the leader already
merges into its :class:`~metrics_tpu_torch.obs.fleet.FleetAggregator`, so
observing costs zero extra fleet traffic. Staleness is respected, not
patched over: a node past ``stale_after_s`` contributes NOTHING to any
reading this cycle (its last-known values are excluded, never extrapolated),
and the excluded node list is part of every journaled cycle.

Per partition (the ``partition=`` label the part plane stamps on engine
series) the book derives:

- **write rate** (events/s): per-node deltas of the cumulative
  ``metrics_tpu_torch_engine_events_total{event="submitted"}`` counter over
  snapshot wall-time, summed across nodes, then EWMA'd. Deltas clamp at
  zero — a counter reset (engine restart, telemetry relabel) reads as a
  quiet interval, never as negative traffic.
- **backlog** (requests): sum of ``metrics_tpu_torch_engine_queue_depth`` gauges.
- **p99 latency** (s): worst ``metrics_tpu_torch_engine_latency_quantile_seconds``
  ``{quantile="0.99"}`` across nodes.

Per engine id the book tracks the hot-tier residency gauge
(``metrics_tpu_torch_tier_residency{tier="hot"}``) for capacity retuning, and the
fleet-wide backlog total for shard growth.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Reading", "SignalBook"]

# the port's own family names (``engine/telemetry.py``, ``obs/instrument.py``):
# the JAX package's ``metrics_tpu_*`` names would match no sample here, and the
# pilot would see an idle fleet

_EVENTS = "metrics_tpu_torch_engine_events_total"
_DEPTH = "metrics_tpu_torch_engine_queue_depth"
_QUANTILE = "metrics_tpu_torch_engine_latency_quantile_seconds"
_RESIDENCY = "metrics_tpu_torch_tier_residency"


@dataclass
class Reading:
    """One target's smoothed signals + how often it has been observed."""

    rate: float = 0.0  # EWMA events/s
    backlog: float = 0.0  # EWMA queued requests
    p99_s: float = 0.0  # EWMA p99 submit->commit latency
    observations: int = 0

    def as_doc(self) -> Dict[str, float]:
        return {
            "rate": round(self.rate, 3),
            "backlog": round(self.backlog, 2),
            "p99_s": round(self.p99_s, 6),
            "observations": self.observations,
        }


def _labels(pairs: Any) -> Dict[str, str]:
    return {str(k): str(v) for k, v in pairs}


class SignalBook:
    """EWMA state over successive fleet observations."""

    def __init__(self, alpha: float) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self._parts: Dict[str, Reading] = {}
        # (node, partition) -> (last cumulative submitted, last t_wall)
        self._submitted: Dict[Tuple[str, str], Tuple[float, float]] = {}
        self._tier_hot: Dict[str, float] = {}  # engine id -> EWMA hot residents
        self._backlog_total = 0.0
        self._observations = 0
        self.excluded_stale: List[str] = []  # last ingest's excluded nodes

    # ------------------------------------------------------------------ ingest

    def ingest(self, aggregator: Any) -> Dict[str, Reading]:
        """Fold the aggregator's current live rows into the book.

        Returns the per-partition readings after this observation. Stale
        nodes are recorded in :attr:`excluded_stale` and contribute nothing.
        """
        rows = aggregator.rows()
        self.excluded_stale = [node for node, _, _, stale in rows if stale]
        live = [(node, snap) for node, snap, _, stale in rows if not stale]

        # raw accumulators for this observation
        rate_by_part: Dict[str, float] = {}
        backlog_by_part: Dict[str, float] = {}
        p99_by_part: Dict[str, float] = {}
        tier_hot: Dict[str, float] = {}
        backlog_total = 0.0

        for node, snap in live:
            t_wall = float(snap.get("t_wall", 0.0))
            families = snap.get("families", {})
            for pairs, value in families.get(_EVENTS, {}).get("samples", ()):
                lab = _labels(pairs)
                part = lab.get("partition")
                if part is None or lab.get("event") != "submitted":
                    continue
                key = (node, part)
                prev = self._submitted.get(key)
                self._submitted[key] = (float(value), t_wall)
                if prev is None:
                    continue  # first sighting: no interval to rate over
                prev_v, prev_t = prev
                dt = t_wall - prev_t
                if dt <= 0:
                    # same snapshot re-ingested: restore the older stamp so the
                    # next genuinely-new snapshot rates over the full interval
                    self._submitted[key] = prev
                    continue
                delta = max(0.0, float(value) - prev_v)  # counter reset -> quiet
                rate_by_part[part] = rate_by_part.get(part, 0.0) + delta / dt
            for pairs, value in families.get(_DEPTH, {}).get("samples", ()):
                lab = _labels(pairs)
                backlog_total += float(value)
                part = lab.get("partition")
                if part is not None:
                    backlog_by_part[part] = backlog_by_part.get(part, 0.0) + float(value)
            for pairs, value in families.get(_QUANTILE, {}).get("samples", ()):
                lab = _labels(pairs)
                part = lab.get("partition")
                if part is None or lab.get("quantile") != "0.99":
                    continue
                p99_by_part[part] = max(p99_by_part.get(part, 0.0), float(value))
            for pairs, value in families.get(_RESIDENCY, {}).get("samples", ()):
                lab = _labels(pairs)
                if lab.get("tier") != "hot":
                    continue
                eid = lab.get("engine", "")
                tier_hot[eid] = tier_hot.get(eid, 0.0) + float(value)

        a = self.alpha
        seen = set(rate_by_part) | set(backlog_by_part) | set(p99_by_part)
        for part in seen:
            r = self._parts.get(part)
            if r is None:
                r = self._parts[part] = Reading()
            r.rate += a * (rate_by_part.get(part, 0.0) - r.rate)
            r.backlog += a * (backlog_by_part.get(part, 0.0) - r.backlog)
            r.p99_s += a * (p99_by_part.get(part, 0.0) - r.p99_s)
            r.observations += 1
        for eid, hot in tier_hot.items():
            prev_hot = self._tier_hot.get(eid, hot)
            self._tier_hot[eid] = prev_hot + a * (hot - prev_hot)
        self._backlog_total += a * (backlog_total - self._backlog_total)
        self._observations += 1
        return dict(self._parts)

    # ------------------------------------------------------------------ reading

    def readings(self) -> Dict[str, Reading]:
        return dict(self._parts)

    def tier_hot(self, engine_id: str) -> Optional[float]:
        """EWMA hot-tier residents for one engine id (None = never observed)."""
        return self._tier_hot.get(engine_id)

    @property
    def backlog_total(self) -> float:
        return self._backlog_total

    @property
    def observations(self) -> int:
        return self._observations

    def as_doc(self) -> Dict[str, Any]:
        """The book's current state, journal-shaped."""
        return {
            "partitions": {p: r.as_doc() for p, r in sorted(self._parts.items())},
            "backlog_total": round(self._backlog_total, 2),
            "excluded_stale": sorted(self.excluded_stale),
            "observations": self._observations,
        }
