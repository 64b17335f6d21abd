"""Span tracing: thread-local context propagation + ring buffer + Chrome trace export
(port of ``metrics_tpu/obs/trace.py``).

Usage::

    from metrics_tpu_torch import obs

    obs.enable()
    with obs.span("metric.update", metric="BinaryF1Score"):
        metric.update(preds, target)
    obs.export_chrome_trace("/tmp/trace.json")   # load in Perfetto / chrome://tracing

Spans nest: each thread carries its own context stack (``threading.local``), so
a span opened inside another records its parent — and concurrent threads (the
engine's client threads + dispatcher) interleave without sharing state. Closed
spans land in a fixed-size ring buffer: sustained tracing overwrites
oldest-first instead of growing without bound, so ``enable()`` is safe to leave
on in a serving process.

The exported JSON is the Chrome trace-event format (one ``"X"`` — complete —
event per span, microsecond timestamps, ``pid``/``tid`` attribution plus
thread-name metadata events), directly loadable in Perfetto or
``chrome://tracing``.

When the master switch is off, :meth:`Tracer.span` returns a shared no-op
context manager after a single attribute test — no allocation, no lock.

Stdlib only.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from metrics_tpu_torch.obs.registry import OBS

# one closed span: (name, start_ns, dur_ns, tid, thread_name, parent_name, attrs)
_SpanRecord = Tuple[str, int, int, int, str, Optional[str], Dict[str, Any]]


class _NullSpan:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc_info: Any) -> bool:
        return False

    def set_attr(self, **attrs: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    """A live span; records itself into the tracer's ring on exit."""

    __slots__ = ("_tracer", "name", "attrs", "_start_ns", "_parent")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]) -> None:
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._start_ns = 0
        self._parent: Optional[str] = None

    def set_attr(self, **attrs: Any) -> None:
        """Attach attributes discovered mid-span (payload sizes, cache hits...)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        stack = self._tracer._stack()
        self._parent = stack[-1] if stack else None
        stack.append(self.name)
        self._start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        end_ns = time.perf_counter_ns()
        stack = self._tracer._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        thread = threading.current_thread()
        self._tracer._record(
            (self.name, self._start_ns, end_ns - self._start_ns, thread.ident or 0,
             thread.name, self._parent, self.attrs)
        )
        return False


class Tracer:
    """Ring-buffered span storage with per-thread context propagation."""

    def __init__(self, capacity: int = 4096) -> None:
        if capacity < 1:
            raise ValueError(f"tracer capacity must be >= 1, got {capacity}")
        self._lock = threading.Lock()
        self._capacity = int(capacity)
        self._ring: List[Optional[_SpanRecord]] = [None] * self._capacity
        self._total = 0  # spans ever recorded; ring index = _total % capacity
        self._local = threading.local()
        # perf_counter epoch for this tracer: exported ts are relative µs
        self._epoch_ns = time.perf_counter_ns()

    # ------------------------------------------------------------------ recording

    def span(self, name: str, **attrs: Any) -> Any:
        """Context manager timing one named region. No-op when obs is disabled."""
        if not OBS.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, record: _SpanRecord) -> None:
        with self._lock:
            self._ring[self._total % self._capacity] = record
            self._total += 1

    def current_span_name(self) -> Optional[str]:
        """The innermost open span on THIS thread (context propagation probe)."""
        stack = self._stack()
        return stack[-1] if stack else None

    def record_span(
        self,
        name: str,
        start_ns: int,
        dur_ns: int,
        parent: Optional[str] = None,
        **attrs: Any,
    ) -> None:
        """Record one ALREADY-MEASURED span directly into the ring.

        For retrospective spans whose boundaries were stamped elsewhere — the
        engine's per-request lifetime span is assembled at future-resolution
        time from timestamps collected across submit/drain/kernel/journal.
        ``start_ns`` is on the ``time.perf_counter_ns`` clock (same epoch the
        live spans use, so exported traces interleave correctly).
        """
        if not OBS.enabled:
            return
        thread = threading.current_thread()
        self._record(
            (name, int(start_ns), max(0, int(dur_ns)), thread.ident or 0,
             thread.name, parent, attrs)
        )

    # ------------------------------------------------------------------ reading

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def total_recorded(self) -> int:
        """Spans ever closed (recorded), including ones the ring overwrote."""
        with self._lock:
            return self._total

    def spans(self) -> List[Dict[str, Any]]:
        """Retained spans, oldest first, as plain dicts (ns timestamps)."""
        with self._lock:
            n = min(self._total, self._capacity)
            start = self._total % self._capacity if self._total > self._capacity else 0
            ordered = [self._ring[(start + i) % self._capacity] for i in range(n)]
        out = []
        for rec in ordered:
            if rec is None:
                continue
            name, start_ns, dur_ns, tid, tname, parent, attrs = rec
            out.append(
                {"name": name, "start_ns": start_ns, "dur_ns": dur_ns, "tid": tid,
                 "thread_name": tname, "parent": parent, "attrs": dict(attrs)}
            )
        return out

    def export_chrome_trace(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Retained spans as a Chrome trace-event document.

        One complete (``"ph": "X"``) event per span with microsecond ``ts``
        (monotone, relative to the tracer's start) and ``dur``, plus one
        ``thread_name`` metadata event per thread seen. Written to ``path``
        as JSON when given; the document is returned either way.
        """
        spans = self.spans()
        pid = os.getpid()
        events: List[Dict[str, Any]] = []
        threads_seen: Dict[int, str] = {}
        for s in spans:
            threads_seen.setdefault(s["tid"], s["thread_name"])
            args = dict(s["attrs"])
            if s["parent"]:
                args["parent"] = s["parent"]
            events.append(
                {
                    "name": s["name"],
                    "cat": "metrics_tpu_torch",
                    "ph": "X",
                    "ts": (s["start_ns"] - self._epoch_ns) / 1e3,
                    "dur": s["dur_ns"] / 1e3,
                    "pid": pid,
                    "tid": s["tid"],
                    "args": args,
                }
            )
        events.sort(key=lambda e: e["ts"])
        meta = [
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": tname}}
            for tid, tname in sorted(threads_seen.items())
        ]
        doc = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
        if path is not None:
            try:
                with open(path, "w") as fh:
                    json.dump(doc, fh)
            except Exception as exc:  # noqa: BLE001 — exporting must never break the host
                doc["export_error"] = repr(exc)
        return doc

    # ------------------------------------------------------------------ lifecycle

    def clear(self) -> None:
        with self._lock:
            self._ring = [None] * self._capacity
            self._total = 0
            self._epoch_ns = time.perf_counter_ns()


TRACER = Tracer()
