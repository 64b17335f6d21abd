"""Black-box flight recorder: always-on bounded event ring + post-mortem bundles
(port of ``metrics_tpu/obs/flight.py``; the bundle kind and version are the JAX
package's, so each package's :func:`load_bundle` reads the other's bundles).

An aircraft-style recorder for the serving stack: while obs is enabled it
keeps a bounded ring of recent *edges* — health transitions, breaker state
changes, membership/lease/live-set movement, guard decisions — alongside the
span ring the tracer already holds. On any **triggering edge** (guard
quarantine, breaker open, watchdog restart, failed election, ``agree_live_set``
shrink) it dumps one self-contained post-mortem bundle:

- the trigger + wall-clock stamp,
- the recent-event ring (the causal run-up),
- the tracer's retained spans as a Chrome trace document,
- a full registry snapshot,
- every registered context provider's view (engines register ``health()`` +
  last WAL seq) — provider
  failures are captured in-bundle, never raised,
- the live-set history (the membership edges retained in the ring).

Triggers are *edges*, not states: the instrument hooks feed state changes in
(:func:`~metrics_tpu_torch.obs.instrument.record_health_transition`,
breaker-state transitions deduped here), so one incident dumps one bundle per
distinct edge however many times the underlying gauge is refreshed.

Bundles are kept in memory (bounded) and, when :meth:`FlightRecorder.configure`
set a directory, written as self-describing JSON files (the JAX package's
``tools/obs_dump.py`` renders them into a causal timeline). Everything is gated on
``OBS.enabled``: disabled, every entry point is one attribute test.

Stdlib only.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from metrics_tpu_torch.obs.registry import OBS, REGISTRY

BUNDLE_KIND = "metrics_tpu-flight"
BUNDLE_VERSION = 1

# the edges that dump a bundle (the JAX package's trigger matrix). The port's
# guard and engine fire the first four, the cluster plane's lost election the
# fifth, the comm plane's live-set agreement the sixth and the pilot's
# actuator (an action that raised) the last
TRIGGERS = (
    "guard_quarantine",
    "engine_quarantine",
    "breaker_open",
    "watchdog_restart",
    "election_failed",
    "live_set_shrink",
    "pilot_action_failed",
)


def _json_safe(x: Any) -> Any:
    """Best-effort conversion of provider output into JSON-serializable data."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, dict):
        return {str(k): _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, set, frozenset)):
        return [_json_safe(v) for v in x]
    return repr(x)


class FlightRecorder:
    """Process-global bounded edge ring + triggered post-mortem bundle dumps."""

    def __init__(self, capacity: int = 1024, max_bundles: int = 8) -> None:
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=int(capacity))
        self._seq = 0
        self._directory: Optional[str] = None
        self._max_bundles = int(max_bundles)
        self._bundles: List[Dict[str, Any]] = []
        self._dump_counts: Dict[str, int] = {}
        self._dumps_total = 0
        # context providers: name -> zero-arg callable returning a JSON-able view
        self._providers: Dict[str, Callable[[], Any]] = {}
        # breaker-edge dedup: (engine, breaker) -> last seen state code
        self._breaker_states: Dict[Any, int] = {}

    # ------------------------------------------------------------------ wiring

    def configure(
        self,
        directory: Optional[str] = None,
        max_bundles: Optional[int] = None,
    ) -> None:
        """Set (or clear) the on-disk bundle directory and the in-memory bound."""
        with self._lock:
            self._directory = directory
            if max_bundles is not None:
                self._max_bundles = int(max_bundles)

    def register_provider(self, name: str, fn: Callable[[], Any]) -> None:
        """Attach a named context provider snapshotted into every bundle.

        Engines register their ``health()`` + WAL position here at
        construction; re-registering a name replaces it (an engine restarted
        under the same id supersedes the dead incarnation's closure).
        """
        with self._lock:
            self._providers[name] = fn

    def unregister_provider(self, name: str) -> None:
        with self._lock:
            self._providers.pop(name, None)

    # ------------------------------------------------------------------ recording

    def record(self, kind: str, **attrs: Any) -> None:
        """Append one edge to the ring (gated; cheap enough for cold paths)."""
        if not OBS.enabled:
            return
        with self._lock:
            self._seq += 1
            self._events.append(
                {"seq": self._seq, "t_wall": time.time(), "kind": kind, **attrs}
            )

    def record_breaker_state(self, engine: str, breaker: str, state_code: int) -> None:
        """Dedup breaker gauge refreshes into edges; dump on the open edge.

        The gauge hook calls this on every publish — only an actual state
        CHANGE lands in the ring, and only the transition *into* open (2)
        triggers a bundle.
        """
        if not OBS.enabled:
            return
        key = (engine, breaker)
        with self._lock:
            prev = self._breaker_states.get(key)
            if prev == state_code:
                return
            self._breaker_states[key] = state_code
        self.record(
            "breaker_state", engine=engine, breaker=breaker,
            state=state_code, prev_state=prev,
        )
        if state_code == 2:
            self.dump("breaker_open", engine=engine, breaker=breaker)

    # ------------------------------------------------------------------ dumping

    def dump(self, trigger: str, **attrs: Any) -> Optional[Dict[str, Any]]:
        """Assemble one self-contained post-mortem bundle for ``trigger``.

        Returns the bundle (also retained in memory and written to the
        configured directory). Never raises: a broken provider or an
        unwritable directory is captured in the bundle itself.
        """
        if not OBS.enabled:
            return None
        from metrics_tpu_torch.obs.trace import TRACER

        with self._lock:
            providers = dict(self._providers)
            events = list(self._events)
            directory = self._directory
            self._dumps_total += 1
            self._dump_counts[trigger] = self._dump_counts.get(trigger, 0) + 1
            serial = self._dumps_total
        contexts: Dict[str, Any] = {}
        for name, fn in providers.items():
            try:
                contexts[name] = _json_safe(fn())
            except Exception as exc:  # noqa: BLE001 — a dead provider is evidence, not an error
                contexts[name] = {"provider_error": repr(exc)}
        bundle: Dict[str, Any] = {
            "bundle": BUNDLE_KIND,
            "version": BUNDLE_VERSION,
            "serial": serial,
            "trigger": trigger,
            "trigger_attrs": _json_safe(attrs),
            "t_wall": time.time(),
            "pid": os.getpid(),
            "events": events,
            "live_set_history": [e for e in events if e["kind"] == "comm_live_set"],
            "trace": TRACER.export_chrome_trace(),
            "registry": REGISTRY.snapshot(),
            "contexts": contexts,
        }
        path = None
        if directory is not None:
            try:
                os.makedirs(directory, exist_ok=True)
                path = os.path.join(directory, f"flight-{serial:04d}-{trigger}.json")
                tmp = path + ".tmp"
                with open(tmp, "w") as fh:
                    json.dump(bundle, fh)
                os.replace(tmp, path)
            except Exception as exc:  # noqa: BLE001 — IO failure must not poison the trigger site
                bundle["write_error"] = repr(exc)
                path = None
        bundle["path"] = path
        with self._lock:
            self._bundles.append(bundle)
            del self._bundles[: -self._max_bundles]
        return bundle

    # ------------------------------------------------------------------ reading

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def bundles(self) -> List[Dict[str, Any]]:
        """Retained in-memory bundles, oldest first."""
        with self._lock:
            return list(self._bundles)

    def dump_counts(self) -> Dict[str, int]:
        """Bundles dumped per trigger since the last clear (exactly-once checks)."""
        with self._lock:
            return dict(self._dump_counts)

    # ------------------------------------------------------------------ lifecycle

    def clear(self) -> None:
        """Drop events, bundles, dedup state and counters; keep wiring
        (directory + providers survive — test isolation mirrors obs.reset())."""
        with self._lock:
            self._events.clear()
            self._seq = 0
            self._bundles.clear()
            self._dump_counts.clear()
            self._dumps_total = 0
            self._breaker_states.clear()


FLIGHT = FlightRecorder()


def load_bundle(path: str) -> Dict[str, Any]:
    """Read one on-disk bundle back, validating the self-describing header."""
    with open(path) as fh:
        bundle = json.load(fh)
    if bundle.get("bundle") != BUNDLE_KIND:
        raise ValueError(f"{path!r} is not a {BUNDLE_KIND} bundle")
    return bundle
