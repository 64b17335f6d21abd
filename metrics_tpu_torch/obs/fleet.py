"""Fleet telemetry aggregation: one merged Prometheus view across hosts
(port of ``metrics_tpu/obs/fleet.py``; the node-snapshot kind and version are the
JAX package's, so either package's aggregator merges the other's snapshots).

Every process's :data:`~metrics_tpu_torch.obs.registry.REGISTRY` is process-local.
This module makes the fleet scrapeable from one place without growing a new
transport: nodes serialise a compact, lossless registry snapshot
(:func:`node_snapshot`) and piggyback it on channels they already own —
repl heartbeat frames (primary → follower) and ``CoordStore`` membership
records (every node → whoever reads the member table, i.e. the leader) — and a
:class:`FleetAggregator` merges whatever arrives into one
``render_prometheus()`` page with a ``node=<id>`` label on every series.

Staleness is first-class: each node's latest snapshot carries an ingest stamp;
past ``stale_after_s`` its series render with
``metrics_tpu_torch_fleet_node_stale{node=...} 1`` (still visible — a silent node is
an alert, not a gap), and past ``retire_after_s`` the node's series are
retired from the page entirely (dead-node label-set hygiene: a fleet that
churns hosts must not accrete series forever).

The snapshot format carries label sets as explicit pairs (never the
``"k=v,k2=v2"`` display string — label values legally contain ``,`` and
``=``), so merging is lossless. Stdlib only.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from metrics_tpu_torch.obs.registry import (
    REGISTRY,
    Histogram,
    Registry,
    _escape_help,
    _fmt_value,
    _render_labels,
)

SNAPSHOT_KIND = "metrics_tpu-fleet-node"
SNAPSHOT_VERSION = 1


def node_snapshot(node_id: str, registry: Optional[Registry] = None) -> Dict[str, Any]:
    """This process's registry as one compact, JSON-able, lossless document.

    Shape: ``{"kind", "version", "node", "t_wall", "families"}`` where each
    family is ``{"type", "help", "samples"}`` and each sample is
    ``[[[label, value], ...], sample_value]`` — histogram sample values are
    ``{"edges", "buckets", "sum", "count"}`` with non-cumulative rows.
    """
    reg = REGISTRY if registry is None else registry
    families: Dict[str, Any] = {}
    for name in reg.names():
        inst = reg.get(name)
        if inst is None:
            continue
        samples: List[Any] = []
        if isinstance(inst, Histogram):
            for key, (row, total, count) in inst.collect().items():
                samples.append(
                    [
                        [list(pair) for pair in key],
                        {
                            "edges": list(inst.edges),
                            "buckets": list(row),
                            "sum": total,
                            "count": count,
                        },
                    ]
                )
        else:
            for key, value in inst.collect().items():
                samples.append([[list(pair) for pair in key], value])
        families[name] = {"type": inst.kind, "help": inst.help, "samples": samples}
    return {
        "kind": SNAPSHOT_KIND,
        "version": SNAPSHOT_VERSION,
        "node": str(node_id),
        "t_wall": time.time(),
        "families": families,
    }


class FleetAggregator:
    """Merge per-node snapshots into one fleet-wide Prometheus/jsonl view."""

    def __init__(
        self,
        stale_after_s: float = 10.0,
        retire_after_s: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if retire_after_s < stale_after_s:
            raise ValueError("retire_after_s must be >= stale_after_s")
        self.stale_after_s = float(stale_after_s)
        self.retire_after_s = float(retire_after_s)
        self._clock = clock
        self._lock = threading.Lock()
        # node -> (snapshot, ingest stamp on self._clock)
        self._nodes: Dict[str, Tuple[Dict[str, Any], float]] = {}
        self._retired: List[str] = []

    # ------------------------------------------------------------------ ingest

    def ingest(self, snap: Dict[str, Any], node_id: Optional[str] = None) -> None:
        """Accept one node snapshot (latest-wins per node)."""
        if not isinstance(snap, dict) or snap.get("kind") != SNAPSHOT_KIND:
            return  # wrong/garbled payload on a shared channel: ignore, don't raise
        node = str(node_id if node_id is not None else snap.get("node", ""))
        if not node:
            return
        with self._lock:
            self._nodes[node] = (snap, self._clock())

    def ingest_members(self, members: Iterable[Any]) -> int:
        """Pull piggybacked snapshots off a ``CoordStore`` member table.

        Any member object with a non-None ``fleet`` attribute contributes;
        returns how many were ingested (the leader's merge-loop heartbeat).
        """
        n = 0
        for member in members:
            snap = getattr(member, "fleet", None)
            if snap is not None:
                self.ingest(snap, node_id=getattr(member, "node_id", None))
                n += 1
        return n

    # ------------------------------------------------------------------ reading

    def _sweep(self, now: float) -> List[Tuple[str, Dict[str, Any], float, bool]]:
        """Retire dead nodes; return live (node, snap, age, stale) rows sorted."""
        with self._lock:
            for node in [
                n for n, (_, t) in self._nodes.items() if now - t > self.retire_after_s
            ]:
                del self._nodes[node]
                self._retired.append(node)
            rows = [
                (node, snap, now - t, now - t > self.stale_after_s)
                for node, (snap, t) in self._nodes.items()
            ]
        rows.sort(key=lambda r: r[0])
        return rows

    def nodes(self) -> Dict[str, Dict[str, Any]]:
        """Per-node liveness view: ``{node: {"age_s", "stale"}}`` (post-sweep)."""
        return {
            node: {"age_s": age, "stale": stale}
            for node, _, age, stale in self._sweep(self._clock())
        }

    def rows(self) -> List[Tuple[str, Dict[str, Any], float, bool]]:
        """Live ``(node, snapshot, age_s, stale)`` rows, post-sweep — the
        consumer-side view (the autopilot's signal source): retired nodes are
        gone, stale ones are flagged so a reader can exclude rather than
        extrapolate."""
        return self._sweep(self._clock())

    def retired(self) -> List[str]:
        """Nodes whose series were retired for silence, in retirement order."""
        with self._lock:
            return list(self._retired)

    def render_prometheus(self) -> str:
        """One merged Prometheus v0.0.4 page: every live node's series with a
        ``node=<id>`` label, plus the fleet meta-series (staleness, ages,
        node count)."""
        rows = self._sweep(self._clock())
        # merged family table: name -> (type, help, [(node, label_pairs, sample)])
        merged: Dict[str, Tuple[str, str, List[Tuple[str, Any, Any]]]] = {}
        for node, snap, _, _ in rows:
            for name, family in sorted(snap.get("families", {}).items()):
                entry = merged.get(name)
                if entry is None:
                    entry = merged[name] = (family["type"], family["help"], [])
                for pairs, sample in family["samples"]:
                    entry[2].append((node, pairs, sample))
        lines: List[str] = [
            "# HELP metrics_tpu_torch_fleet_nodes Live nodes currently contributing "
            "series to this fleet view.",
            "# TYPE metrics_tpu_torch_fleet_nodes gauge",
            f"metrics_tpu_torch_fleet_nodes {len(rows)}",
            "# HELP metrics_tpu_torch_fleet_node_stale 1 while the labeled node's "
            "snapshot is older than stale_after_s (silent node), else 0.",
            "# TYPE metrics_tpu_torch_fleet_node_stale gauge",
        ]
        for node, _, _, stale in rows:
            lines.append(
                f"metrics_tpu_torch_fleet_node_stale{_render_labels((('node', node),))} "
                f"{1 if stale else 0}"
            )
        lines.append(
            "# HELP metrics_tpu_torch_fleet_node_age_seconds Seconds since the labeled "
            "node's snapshot was last ingested."
        )
        lines.append("# TYPE metrics_tpu_torch_fleet_node_age_seconds gauge")
        for node, _, age, _ in rows:
            lines.append(
                f"metrics_tpu_torch_fleet_node_age_seconds"
                f"{_render_labels((('node', node),))} {_fmt_value(age)}"
            )
        for name in sorted(merged):
            kind, help_text, samples = merged[name]
            if help_text:
                lines.append(f"# HELP {name} {_escape_help(help_text)}")
            lines.append(f"# TYPE {name} {kind}")
            # node label leads; a node's own `node=` label (cluster series) is
            # overridden by the fleet's authoritative attribution
            keyed = []
            for node, pairs, sample in samples:
                label_key = tuple(
                    [("node", node)]
                    + [(str(k), str(v)) for k, v in pairs if str(k) != "node"]
                )
                keyed.append((label_key, sample))
            keyed.sort(key=lambda kv: kv[0])
            for label_key, sample in keyed:
                if kind == "histogram":
                    edges = sample["edges"]
                    row = sample["buckets"]
                    cumulative = 0
                    for i, edge in enumerate(edges):
                        cumulative += row[i]
                        labels = _render_labels(label_key + (("le", _fmt_value(edge)),))
                        lines.append(f"{name}_bucket{labels} {cumulative}")
                    labels = _render_labels(label_key + (("le", "+Inf"),))
                    lines.append(f"{name}_bucket{labels} {sample['count']}")
                    lines.append(
                        f"{name}_sum{_render_labels(label_key)} {_fmt_value(sample['sum'])}"
                    )
                    lines.append(f"{name}_count{_render_labels(label_key)} {sample['count']}")
                else:
                    lines.append(
                        f"{name}{_render_labels(label_key)} {_fmt_value(sample)}"
                    )
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """The fleet view as one plain dict (jsonl / dashboards / tests)."""
        rows = self._sweep(self._clock())
        return {
            "what": "obs_fleet",
            "nodes": {
                node: {"age_s": age, "stale": stale, "t_wall": snap.get("t_wall")}
                for node, snap, age, stale in rows
            },
            "retired": self.retired(),
            "families": sorted(
                {name for _, snap, _, _ in rows for name in snap.get("families", {})}
            ),
        }

    # ------------------------------------------------------------------ lifecycle

    def clear(self) -> None:
        with self._lock:
            self._nodes.clear()
            self._retired.clear()


# The process-global aggregator: repl appliers and cluster leaders ingest here
# by default, so `fleet.AGGREGATOR.render_prometheus()` is the one-endpoint
# scrape a ClusterClient host serves. Tests may build private instances.
AGGREGATOR = FleetAggregator()
