"""Engine observability: counters, batch-occupancy histogram, submit→result latency
(port of ``metrics_tpu/engine/telemetry.py``).

Every engine series lives in the process-global ``REGISTRY`` of
:mod:`metrics_tpu_torch.obs.registry` under a per-engine ``engine=<id>``
label, so one Prometheus scrape (``REGISTRY.render_prometheus()``) exposes
every live engine. Recording is unconditional: the engine's own telemetry does
not ride the ``obs.enable()`` master switch.

:meth:`EngineTelemetry.snapshot` returns the JAX package's keys: the counters,
``queue_depth``, ``resize_seconds``, ``batch_occupancy_hist``, ``latency_s`` and
``mean_batch_occupancy``. The counters of the planes that are not ported yet
(guard, replication, tier) are declared and read 0, so a dashboard built on the
JAX engine reads the port's unchanged.

Counter names are a closed set: :meth:`count` on a name that was never declared
raises instead of silently minting a new series; extend the set explicitly with
:meth:`register_counter`.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, Optional

import numpy as np

from metrics_tpu_torch.obs.jsonl import append_jsonl
from metrics_tpu_torch.obs.registry import REGISTRY, Registry

# Batch-occupancy histogram edges: fraction of real (unmasked) rows per dispatched
# micro-batch. Low occupancy means the bucket ladder is too coarse for the traffic.
_OCCUPANCY_EDGES = (0.25, 0.5, 0.75, 1.0)

# submit→commit latency edges (seconds): 100µs → 10s decades, engine-shaped
_LATENCY_EDGES = (1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)

_COUNTERS = (
    "submitted",          # requests accepted into the queue (or applied inline)
    "processed",          # requests whose state update committed
    "failed",             # requests completed with an exception
    "dropped",            # rejected by the drop policy at a full queue
    "timed_out",          # rejected by the timeout policy at a full queue
    "batches",            # micro-batches dispatched
    "rows",               # real rows committed
    "padded_rows",        # masked filler rows dispatched
    "compiles",           # micro-batch graph captures (the JAX package counts traces)
    "fused_fallbacks",    # fused→eager demotions (untraceable metric update)
    "inline_dispatches",  # requests applied synchronously (degraded mode)
    "worker_deaths",      # dispatcher thread crashes survived
    "window_rotations",   # sliding-window segment rotations
    "key_growths",        # tenant-capacity doublings (each costs one capture set)
    # durable state plane
    "checkpoints",          # snapshots committed (periodic + quiesce + close)
    "checkpoint_failures",  # snapshot/serialize/commit failures absorbed
    "wal_records",          # requests journaled ahead of their state commit
    "replayed",             # journaled requests re-applied during recovery
    "recoveries",           # restart-time restores from a valid snapshot
    # guard plane (ROADMAP A.7: not ported yet, these read 0)
    "shed",                    # requests dropped by the overload controller
    "quota_rejections",        # submits refused by a tenant's token bucket
    "deadline_expired",        # requests whose deadline lapsed before dispatch
    "quarantines",             # tenants placed under failure probation
    "quarantine_rejections",   # submits failed fast from quarantined tenants
    "compile_rejections",      # novel-signature chunks routed eager by the compile breaker
    "ckpt_suspended",          # snapshot attempts skipped while the ckpt breaker is open
    "sync_pinned",             # sync=True computes served local state (comm breaker open)
    "worker_hangs",            # dispatchers declared hung by the watchdog
    "watchdog_restarts",       # fresh dispatchers started after a hang/death takeover
    # zombie surfacing is guard-independent: close() counts a worker that
    # outlived its join timeout whether or not a guard plane is configured
    "zombie_workers",
    # replication plane (ROADMAP A.7: not ported yet, these read 0)
    "shipped_records",      # WAL records published over the repl transport (primary)
    "shipped_snapshots",    # snapshot frames published (bootstrap + re-ship)
    "ship_failures",        # transient transport send failures absorbed + retried
    "applied_records",      # shipped WAL records replayed into local state (follower)
    "snapshot_loads",       # follower bootstraps/re-bootstraps from a shipped snapshot
    "fenced_rejections",    # frames/sends rejected by epoch fencing (zombie primary)
    "ship_journal_lost",    # shipper parked: engine disabled its WAL (IO failure)
    "ship_history_holes",   # bootstrap parked: best valid snapshot + retained WAL can't form a chain
    "apply_failures",       # follower frames that raised during apply (absorbed)
    "stale_read_refusals",  # follower reads refused beyond max_staleness
    "promotions",           # follower→primary promotions served by this engine
    "demotions",            # primary→follower step-downs (lease loss / re-attach)
    "read_jit_fallbacks",   # compiled read path disabled (the port reads eagerly: stays 0)
    # tier plane (ROADMAP A.7: not ported yet, these read 0)
    "tier_promotions",      # readmissions into the device slab (warm/cold -> hot)
    "tier_demotions",       # demotions out of the slab (hot -> warm mirror)
    "tier_spills",          # warm entries pushed to disk (warm -> cold)
    "tier_spill_failures",  # spill write failures absorbed (tenant stays warm)
    "tier_evictions",       # journaled tenant retirements (evict/export)
)

# distinguishes engines within one process; monotone so labels never collide
_ENGINE_IDS = itertools.count()

# observations between exported-quantile refreshes: the nearest-rank pass over
# the ring is O(window log window) — amortised to noise at this cadence
_QUANTILE_REFRESH = 64


class EngineTelemetry:
    """Registry-backed counters + histograms for one :class:`StreamingEngine`."""

    def __init__(
        self,
        latency_window: int = 2048,
        registry: Optional[Registry] = None,
        labels: Optional[Dict[str, str]] = None,
    ) -> None:
        reg = registry if registry is not None else REGISTRY
        self._registry = reg
        self.engine_id = str(next(_ENGINE_IDS))
        # extra labels ride on EVERY series of this engine — the shard plane
        # passes {"shard": "<i>"} so queue depth / occupancy / compiles are
        # filterable per shard in one Prometheus scrape
        self._label = {"engine": self.engine_id, **(labels or {})}

        self._events = reg.counter(
            "metrics_tpu_torch_engine_events_total", "StreamingEngine request/dispatch lifecycle events."
        )
        self._depth = reg.gauge(
            "metrics_tpu_torch_engine_queue_depth", "Requests queued but not yet drained by the dispatcher."
        )
        self._occupancy = reg.histogram(
            "metrics_tpu_torch_engine_batch_occupancy",
            "Fraction of real (unmasked) rows per dispatched micro-batch.",
            buckets=_OCCUPANCY_EDGES,
        )
        self._latency = reg.histogram(
            "metrics_tpu_torch_engine_latency_seconds",
            "submit()→commit latency, backpressure stalls included.",
            buckets=_LATENCY_EDGES,
        )
        self._resize_seconds = reg.counter(
            "metrics_tpu_torch_engine_resize_seconds",
            "Cumulative wall time spent growing the stacked tenant slab "
            "(capacity doublings).",
        )
        self._resize_key = self._resize_seconds.label_key(**self._label)
        self._resize_seconds.inc_key(self._resize_key, 0)

        # closed counter-name set, in declaration order (snapshot key order);
        # label identities are precomputed ONCE so the per-request hot path
        # (submit/process) does a bare
        # dict-add under the counter lock — no per-call validation/sort/str
        self._allowed = list(_COUNTERS)
        self._event_keys = {
            name: self._events.label_key(event=name, **self._label) for name in self._allowed
        }
        for key in self._event_keys.values():
            self._events.inc_key(key, 0)
        self._depth_key = self._depth.label_key(**self._label)
        self._depth.set_key(self._depth_key, 0)
        self._occupancy_key = self._occupancy.label_key(**self._label)
        self._latency_key = self._latency.label_key(**self._label)

        # exact percentiles as scrapeable gauges: the bucketed histogram only
        # bounds quantiles to an edge pair, but the ring below holds exact
        # recent samples — export nearest-rank p50/p99 from it, refreshed every
        # _QUANTILE_REFRESH observations (the np.percentile pass is too costly
        # per-request) and on every snapshot()
        self._quantile = reg.gauge(
            "metrics_tpu_torch_engine_latency_quantile_seconds",
            "Exact nearest-rank submit()→commit latency percentiles over the "
            "telemetry ring window (recent requests, not lifetime).",
        )
        self._quantile_keys = {
            q: self._quantile.label_key(quantile=q, **self._label) for q in ("0.5", "0.99")
        }

        # latency ring: fixed-size, overwritten oldest-first — exact-percentile
        # quality degrades gracefully under sustained load instead of growing
        # without bound (the registry histogram keeps only bucketed counts)
        self._ring_lock = threading.Lock()
        self._latencies = np.zeros(max(8, int(latency_window)), dtype=np.float64)
        self._lat_count = 0

    # ------------------------------------------------------------------ labeling

    def add_labels(self, **labels: str) -> None:
        """Stamp extra labels onto EVERY series of this engine, in place.

        The partition plane calls this at engine adoption
        (``partition="p<N>"``) so write-rate/backlog/latency attribution
        needs no client-side joins — the same contract the shard plane gets
        by passing ``telemetry_labels={"shard": ...}`` at construction, made
        retrofittable for engines built before their supervisor existed.

        Counter totals carry over to the relabeled series (cumulative-rate
        consumers like the autopilot see a rename, not a reset); histogram
        and quantile history restarts (bucket rows are not relabel-safe to
        merge). Keys already present with the same value are no-ops; a
        CONFLICTING value raises — two owners disagreeing about an engine's
        identity is a wiring bug, not a relabel.
        """
        new = {k: str(v) for k, v in labels.items() if self._label.get(k) != str(v)}
        for key in new:
            if key in self._label:
                raise ValueError(
                    f"telemetry label {key!r} is already {self._label[key]!r}; "
                    f"refusing to relabel to {new[key]!r} — one engine, one identity"
                )
        if not new:
            return
        old_label = dict(self._label)
        old_events = self._events.collect()
        carried = {
            name: float(old_events.get(key, 0.0)) for name, key in self._event_keys.items()
        }
        carried_resize = float(self._resize_seconds.value(**old_label))
        for inst in (self._events, self._depth, self._occupancy, self._latency,
                     self._resize_seconds, self._quantile):
            inst.drop_labels(**old_label)
        self._label = {**old_label, **new}
        self._resize_key = self._resize_seconds.label_key(**self._label)
        self._resize_seconds.inc_key(self._resize_key, carried_resize)
        self._event_keys = {
            name: self._events.label_key(event=name, **self._label) for name in self._allowed
        }
        for name, key in self._event_keys.items():
            self._events.inc_key(key, carried.get(name, 0))
        self._depth_key = self._depth.label_key(**self._label)
        self._depth.set_key(self._depth_key, 0)
        self._occupancy_key = self._occupancy.label_key(**self._label)
        self._latency_key = self._latency.label_key(**self._label)
        self._quantile_keys = {
            q: self._quantile.label_key(quantile=q, **self._label) for q in ("0.5", "0.99")
        }

    def label(self, name: str, default: str = "") -> str:
        """One stamped label's value (e.g. ``partition`` after adoption)."""
        return self._label.get(name, default)

    # ------------------------------------------------------------------ recording

    def register_counter(self, name: str) -> None:
        """Declare an extra counter name; only declared names may be counted."""
        if name not in self._allowed:
            self._allowed.append(name)
            key = self._events.label_key(event=name, **self._label)
            self._event_keys[name] = key
            self._events.inc_key(key, 0)

    def count(self, name: str, n: int = 1) -> None:
        key = self._event_keys.get(name)
        if key is None:
            raise KeyError(
                f"unknown telemetry counter {name!r}; declared: {sorted(self._allowed)}. "
                "Declare new names explicitly with register_counter() — a typo'd counter "
                "that silently reads 0 forever is a debugging trap."
            )
        self._events.inc_key(key, n)

    def gauge_queue_depth(self, depth: int) -> None:
        self._depth.set_key(self._depth_key, depth)

    def observe_batch(self, real_rows: int, bucket: int) -> None:
        frac = real_rows / bucket if bucket else 0.0
        # one lock acquisition for the batch's three counters: a concurrent
        # snapshot never sees rows committed without their batch/padding
        self._events.inc_many_keys(
            [
                (1, self._event_keys["batches"]),
                (real_rows, self._event_keys["rows"]),
                (bucket - real_rows, self._event_keys["padded_rows"]),
            ]
        )
        self._occupancy.observe_key(self._occupancy_key, frac)

    def observe_resize(self, seconds: float) -> None:
        """Add one slab-growth's wall time to ``metrics_tpu_torch_engine_resize_seconds``."""
        self._resize_seconds.inc_key(self._resize_key, float(seconds))

    def observe_latency(self, seconds: float) -> None:
        self._latency.observe_key(self._latency_key, seconds)
        with self._ring_lock:
            self._latencies[self._lat_count % len(self._latencies)] = seconds
            self._lat_count += 1
            refresh = self._lat_count % _QUANTILE_REFRESH == 0
        if refresh:
            self._refresh_quantiles()

    def _refresh_quantiles(self) -> None:
        """Recompute the exported p50/p99 gauges from the latency ring."""
        with self._ring_lock:
            n = min(self._lat_count, len(self._latencies))
            lat = np.array(self._latencies[:n]) if n else None
        if lat is None:
            return
        p50, p99 = np.percentile(lat, [50, 99], method="nearest")
        self._quantile.set_key(self._quantile_keys["0.5"], float(p50))
        self._quantile.set_key(self._quantile_keys["0.99"], float(p99))

    # ------------------------------------------------------------------ reading

    def snapshot(self) -> Dict[str, Any]:
        """All counters + derived stats as one plain dict (original flat shape)."""
        # ONE collect() == one lock acquisition across every event series: the
        # counters are mutually consistent (submitted >= processed etc.), as the
        # pre-registry single-lock snapshot was
        events = self._events.collect()
        out: Dict[str, Any] = {
            name: int(events.get(self._event_keys[name], 0)) for name in self._allowed
        }
        out["queue_depth"] = int(self._depth.value(**self._label))
        out["resize_seconds"] = float(self._resize_seconds.value(**self._label))
        occ = self._occupancy.bucket_counts(**self._label)
        out["batch_occupancy_hist"] = {f"<={edge}": occ[edge] for edge in _OCCUPANCY_EDGES}
        with self._ring_lock:
            n = min(self._lat_count, len(self._latencies))
            lat = np.array(self._latencies[:n]) if n else None
            total = self._lat_count
        if lat is not None:
            # nearest-rank percentiles: p99 reaches max on small n (index
            # truncation made it unreachable below n=100 and degraded badly on a
            # partially-filled ring), and n=1 / wrapped-ring cases are exact
            p50, p99 = np.percentile(lat, [50, 99], method="nearest")
            # a snapshot is also a scrape point: publish fresh gauges so the
            # exported quantiles are never staler than the last snapshot
            self._quantile.set_key(self._quantile_keys["0.5"], float(p50))
            self._quantile.set_key(self._quantile_keys["0.99"], float(p99))
            out["latency_s"] = {
                "count": int(total),
                "p50": float(p50),
                "p99": float(p99),
                "max": float(lat.max()),
            }
        else:
            out["latency_s"] = {"count": 0, "p50": None, "p99": None, "max": None}
        out["mean_batch_occupancy"] = (
            out["rows"] / (out["rows"] + out["padded_rows"]) if out["batches"] else None
        )
        return out

    def emit(self, path: str, **extra: Any) -> Dict[str, Any]:
        """Append one snapshot as a JSONL record through the shared writer
        (:mod:`metrics_tpu_torch.obs.jsonl`)."""
        record: Dict[str, Any] = {"what": "engine_telemetry", **self.snapshot(), **extra}
        append_jsonl(path, record)
        return record

    # ------------------------------------------------------------------ lifecycle

    def retire(self) -> None:
        """Evict this engine's series from the process-global registry.

        The registry never evicts on its own, so a long-lived process creating
        many transient engines should call this once an engine (and any
        post-close snapshot reads — benchmarks read after ``close()``) is done
        with, or every future Prometheus scrape carries the dead engine's
        series. Recording after ``retire()`` is harmless: the series simply
        rematerialise.
        """
        for inst in (self._events, self._depth, self._occupancy, self._latency,
                     self._resize_seconds, self._quantile):
            inst.drop_labels(**self._label)
