"""metrics_tpu_torch.obs — library-wide observability (port of ``metrics_tpu/obs``):
the metrics registry, span tracing with cross-host trace contexts, the flight
recorder and fleet telemetry.

One process-global, stdlib-only subsystem spanning the whole stack::

    from metrics_tpu_torch import obs

    obs.enable()                                  # master switch (default: off)
    with obs.span("eval.epoch", split="val"):     # your spans nest with the library's
        metric.update(preds, target)              # -> metric.update span + wall-time histogram
    obs.snapshot()                                # everything as one plain dict
    print(obs.render_prometheus())                # Prometheus v0.0.4 text exposition
    obs.export_chrome_trace("trace.json")         # load in Perfetto / chrome://tracing
    obs.disable()

Layout: :mod:`~metrics_tpu_torch.obs.registry` (labeled counters, gauges and
histograms, the exposition and the :data:`OBS` master gate),
:mod:`~metrics_tpu_torch.obs.trace` (thread-local spans, ring buffer, Chrome
trace export), :mod:`~metrics_tpu_torch.obs.context` (the trace context a
request carries through the WAL and the replication plane),
:mod:`~metrics_tpu_torch.obs.flight` (the flight recorder),
:mod:`~metrics_tpu_torch.obs.fleet` (node snapshots and their aggregator),
:mod:`~metrics_tpu_torch.obs.instrument` (the hooks the library calls) and
:mod:`~metrics_tpu_torch.obs.jsonl` (the one JSONL writer). With the switch
off, every hook exits after one attribute test.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from metrics_tpu_torch.obs.jsonl import append_jsonl
from metrics_tpu_torch.obs.registry import OBS, REGISTRY, Counter, Gauge, Histogram, ObsGate, Registry
from metrics_tpu_torch.obs.trace import TRACER, Tracer
from metrics_tpu_torch.obs.context import TraceContext, activate, current, mint
from metrics_tpu_torch.obs.fleet import AGGREGATOR, FleetAggregator, node_snapshot
from metrics_tpu_torch.obs.flight import FLIGHT, FlightRecorder, load_bundle
from metrics_tpu_torch.obs import instrument  # noqa: F401  (registers the hook instruments)


def enable() -> None:
    """Turn on library-wide instrumentation (spans, op timing, flight recording)."""
    OBS.enabled = True


def disable() -> None:
    """Turn instrumentation off. Recorded data is kept; recording stops."""
    OBS.enabled = False


def enabled() -> bool:
    return OBS.enabled


def span(name: str, **attrs: Any) -> Any:
    """Open a trace span on the process tracer (no-op context manager when disabled)."""
    return TRACER.span(name, **attrs)


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "", buckets: Any = None) -> Histogram:
    return REGISTRY.histogram(name, help, buckets=buckets)


def snapshot() -> Dict[str, Any]:
    """The whole registry as one plain dict."""
    return REGISTRY.snapshot()


def render_prometheus() -> str:
    """Prometheus text exposition (serve with ``Content-Type: text/plain; version=0.0.4``)."""
    return REGISTRY.render_prometheus()


def export_chrome_trace(path: Optional[str] = None) -> Dict[str, Any]:
    """Retained spans as Chrome trace-event JSON (optionally written to ``path``)."""
    return TRACER.export_chrome_trace(path)


def emit(path: str, **extra: Any) -> Dict[str, Any]:
    """Append one registry snapshot as a JSONL record through the shared writer."""
    return REGISTRY.emit(path, **extra)


def reset() -> None:
    """Disable and clear all recorded values, spans, flight evidence and fleet
    state, keeping registered instruments (and references held to them) valid.
    Test-isolation hook."""
    disable()
    REGISTRY.clear_values()
    TRACER.clear()
    FLIGHT.clear()
    AGGREGATOR.clear()


__all__ = [
    "AGGREGATOR",
    "FLIGHT",
    "FleetAggregator",
    "FlightRecorder",
    "OBS",
    "REGISTRY",
    "TRACER",
    "Counter",
    "Gauge",
    "Histogram",
    "ObsGate",
    "Registry",
    "TraceContext",
    "Tracer",
    "activate",
    "append_jsonl",
    "counter",
    "current",
    "disable",
    "emit",
    "enable",
    "enabled",
    "export_chrome_trace",
    "gauge",
    "histogram",
    "instrument",
    "load_bundle",
    "mint",
    "node_snapshot",
    "render_prometheus",
    "reset",
    "snapshot",
    "span",
]
