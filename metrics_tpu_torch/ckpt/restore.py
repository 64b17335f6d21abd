"""Restore path: strict schema validation, migrations, and ``save``/``restore``
(port of ``metrics_tpu/ckpt/restore.py``).

``save(obj, path)`` captures a metric's (or collection's) FULL registered
state — persistence flags are forced on for the duration, so the capture rides
the exact ``state_dict`` machinery the library already trusts (nested child
metrics and compute-group leader refresh included) without permanently
flipping anyone's flags. Update counts are carried alongside so a restored
metric keeps its running-mean and warning semantics. Every tensor is copied to
the host as a numpy array before the tree is serialized, so a snapshot holds
no framework object and the JAX package reads it as it reads its own.

``restore(obj, path)`` is strict by construction, three layers deep:

1. **integrity** — the blob's magic/CRCs (a corrupt file raises
   :class:`~metrics_tpu_torch.ckpt.format.CorruptSnapshotError`, it is never
   partially applied);
2. **schema** — the snapshot's ``schema_version`` is bridged to the current
   one through the migration-hook registry (:func:`register_migration`); a
   version gap with no registered bridge refuses loudly;
3. **structure** — every fixed array state is checked against the live
   instance's registered spec (unknown state names, missing states, dtype and
   shape mismatches each raise :class:`CkptSchemaError` *before* any attribute
   is touched), then the payload rides the existing strict
   ``load_state_dict``, which makes each leaf a tensor on the metric's device
   (missing persistent keys and unconsumed stray keys raise there).

After a collection restore the compute-group aliasing is re-established:
group members are re-pointed at their leader's freshly restored tensors, and
every member's compute cache is dropped — a restore must never leave a member
serving pre-restore state.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.ckpt import format as ckpt_format
from metrics_tpu_torch.ckpt.format import Snapshot
from metrics_tpu_torch.ckpt.store import atomic_write
from metrics_tpu_torch.comm.codec import CodecPolicy
from metrics_tpu_torch.obs import instrument as _obs

__all__ = [
    "CKPT_SCHEMA_VERSION",
    "CkptSchemaError",
    "clear_migrations",
    "migrate",
    "register_migration",
    "restore",
    "save",
]

# The CURRENT payload schema for metric/collection snapshots. Bump when the
# save-tree layout changes, and register a migration bridging the old version.
CKPT_SCHEMA_VERSION = 1


class CkptSchemaError(Exception):
    """The snapshot does not fit the live instance (or its schema version)."""


# ---------------------------------------------------------------------- migrations

_MIGRATIONS: Dict[int, Callable[[Any, Dict[str, Any]], Any]] = {}


def register_migration(from_version: int, fn: Callable[[Any, Dict[str, Any]], Any]) -> None:
    """Register ``fn(tree, meta) -> tree`` bridging ``from_version`` → ``from_version + 1``.

    Chained automatically: restoring a v1 snapshot at schema v3 runs the 1→2
    then the 2→3 hook. Registering a version twice raises — two subsystems
    disagreeing about a bridge is a bug, not a merge.
    """
    v = int(from_version)
    if v in _MIGRATIONS:
        raise ValueError(f"migration from schema version {v} already registered")
    _MIGRATIONS[v] = fn


def clear_migrations() -> None:
    """Drop all registered hooks (test isolation)."""
    _MIGRATIONS.clear()


def migrate(snapshot: Snapshot, target_version: int) -> Any:
    """Bridge ``snapshot.tree`` up to ``target_version`` through the registry."""
    tree, version = snapshot.tree, snapshot.schema_version
    if version > target_version:
        raise CkptSchemaError(
            f"snapshot schema v{version} is NEWER than this library's v{target_version} — "
            "refusing to guess at a downgrade"
        )
    while version < target_version:
        fn = _MIGRATIONS.get(version)
        if fn is None:
            raise CkptSchemaError(
                f"snapshot schema v{version} has no registered migration to v{version + 1} "
                f"(target v{target_version}); register one with ckpt.register_migration"
            )
        tree = fn(tree, snapshot.meta)
        version += 1
    return tree


# ---------------------------------------------------------------------- host views

def host_tree(tree: Any) -> Any:
    """``tree`` with every tensor replaced by a numpy copy on the host (dicts,
    lists and tuples rebuilt, anything else kept): what the snapshot format
    serializes. Count states keep their dtype (int32 stays int32). A CPU
    tensor is copied too, so the copy never aliases a slab that later writes
    change."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True).numpy()
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_tree(v) for v in tree)
    return tree


def dtype_name(x: Any) -> str:
    """The numpy name of a tensor's or an array's dtype (``torch.int32`` →
    ``"int32"``), so the two compare without converting either."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.dtype(x.dtype).name


# ---------------------------------------------------------------------- walking

def _is_collection(obj: Any) -> bool:
    from metrics_tpu_torch.collections import MetricCollection

    return isinstance(obj, MetricCollection)


def _walk_metrics(obj: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(state_dict prefix, metric) for obj + every nested child, depth-first —
    the same recursion ``state_dict``/``load_state_dict`` route through."""
    from metrics_tpu_torch.metric import Metric

    if _is_collection(obj):
        for name, m in obj._modules.items():
            yield from _walk_metrics(m, f"{prefix}{name}.")
        return
    if isinstance(obj, Metric):
        yield prefix, obj
        for name, child in obj._child_metrics():
            yield from _walk_metrics(child, f"{prefix}{name}.")
        return
    # a MetricTracker is neither a Metric nor a collection: walk its history
    # under the prefixes its own state_dict uses
    tracked = getattr(obj, "_metrics", None)
    if isinstance(tracked, (list, tuple)):
        for i, m in enumerate(tracked):
            yield from _walk_metrics(m, f"{prefix}_metrics.{i}.")


@contextmanager
def _all_persistent(obj: Any) -> Iterator[None]:
    """Force every state persistent for the block, restoring flags after —
    ``save``/``restore`` capture full state through the parity ``state_dict``
    machinery without changing what the user's own checkpoints contain."""
    saved = [(m, dict(m._persistent)) for _, m in _walk_metrics(obj)]
    for m, _ in saved:
        for key in m._persistent:
            m._persistent[key] = True
    try:
        yield
    finally:
        for m, flags in saved:
            m._persistent.update(flags)


# ---------------------------------------------------------------------- save

def _build_tree(obj: Any) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(snapshot tree, name→reduction map for the codec policy)."""
    with _all_persistent(obj):
        sd = host_tree(obj.state_dict())
    reductions: Dict[str, Any] = {}
    counts: Dict[str, int] = {}
    for prefix, m in _walk_metrics(obj):
        counts[prefix] = int(m._update_count)
        for name, red in m._reductions.items():
            if isinstance(red, str):
                reductions.setdefault(name, red)
    tree = {
        "kind": "collection" if _is_collection(obj) else "metric",
        "class": type(obj).__name__,
        "state_dict": sd,
        "update_counts": counts,
    }
    return tree, reductions


def save(
    obj: Any,
    path: str,
    *,
    policy: Optional[CodecPolicy] = None,
    meta: Optional[Dict[str, Any]] = None,
    durable: bool = True,
) -> None:
    """Write one atomic, checksummed snapshot of ``obj``'s full state to ``path``.

    ``policy=None`` (the default) is lossless — ``restore`` then reproduces
    ``compute()`` bit-identically. A lossy :class:`CodecPolicy` is opt-in and
    applies the codecs' dtype/reduction exactness rules (counts stay exact).
    """
    t0 = time.perf_counter()
    with _obs.ckpt_span("ckpt.save", site="metric", cls=type(obj).__name__):
        tree, reductions = _build_tree(obj)
        from metrics_tpu_torch import __version__

        full_meta = {"library_version": __version__, **(meta or {})}
        data = ckpt_format.dumps(
            tree,
            policy=policy,
            reductions=reductions,
            schema_version=CKPT_SCHEMA_VERSION,
            meta=full_meta,
        )
        atomic_write(path, data, durable=durable)
    _obs.record_ckpt_io("metric", "write", len(data), time.perf_counter() - t0)


# ---------------------------------------------------------------------- validate + apply

def _validate_tree(obj: Any, tree: Any, *, strict_shapes: bool = True) -> None:
    """Structural checks of the snapshot against the live instance — all
    failures raise BEFORE any attribute is touched.

    Key-set enforcement (missing persistent keys, unconsumed strays) is NOT
    duplicated here: that rides the existing strict ``load_state_dict``
    machinery. What load can't check is *parameters*: a key that exists on
    both sides but with the wrong dtype or shape would silently poison the
    next update, so those are compared against the live instance's own
    serialized view here.
    """
    if not isinstance(tree, dict) or "state_dict" not in tree:
        raise CkptSchemaError("snapshot tree is not a metric checkpoint (no state_dict)")
    expected_kind = "collection" if _is_collection(obj) else "metric"
    if tree.get("kind") != expected_kind:
        raise CkptSchemaError(
            f"snapshot holds a {tree.get('kind')!r}, live instance is a {expected_kind} "
            f"({type(obj).__name__})"
        )
    sd = tree["state_dict"]
    if not isinstance(sd, dict):
        raise CkptSchemaError("snapshot state_dict is not a mapping")
    with _all_persistent(obj):
        live = obj.state_dict()
    problems = []
    for key, expected in live.items():
        if key not in sd:
            continue  # strict load_state_dict raises on genuinely missing keys
        val = sd[key]
        if isinstance(expected, (list, tuple)):
            if not isinstance(val, (list, tuple)):
                problems.append(
                    f"state {key!r}: expected a list ('cat') state, got {type(val).__name__}"
                )
            continue
        if not (hasattr(expected, "dtype") and hasattr(expected, "shape")):
            continue  # host-object payloads: opaque to structural checks
        if not (hasattr(val, "dtype") and hasattr(val, "shape")):
            problems.append(f"state {key!r}: expected an array, got {type(val).__name__}")
            continue
        if dtype_name(val) != dtype_name(expected):
            problems.append(f"state {key!r}: dtype {dtype_name(val)} != live {dtype_name(expected)}")
        if strict_shapes and tuple(val.shape) != tuple(expected.shape):
            problems.append(
                f"state {key!r}: shape {tuple(val.shape)} != live {tuple(expected.shape)}"
            )
    if problems:
        shown = "; ".join(problems[:6]) + (" ..." if len(problems) > 6 else "")
        raise CkptSchemaError(f"snapshot does not fit {type(obj).__name__}: {shown}")


def _apply_tree(obj: Any, tree: Dict[str, Any]) -> None:
    sd = dict(tree["state_dict"])
    # numpy leaves go in verbatim: load_state_dict makes each a tensor on the
    # metric's device (list states become lists of tensors)
    with _all_persistent(obj):
        obj.load_state_dict(sd, strict=True)
    counts = tree.get("update_counts", {})
    for prefix, m in _walk_metrics(obj):
        if prefix in counts:
            m._update_count = int(counts[prefix])
        # a restore invalidates everything derived from pre-restore state
        m._update_called = m._update_count > 0
        m._computed = None
        m._cache = None
        m._is_synced = False
        m._batch_state = None
    if _is_collection(obj):
        # Re-establish compute-group aliasing: members must point at their
        # leader's freshly restored tensors, not at whatever they held before
        # (the regression this guards: a member serving stale pre-restore
        # state from its own _computed cache or un-aliased tensors).
        if obj._groups_checked:
            obj._compute_groups_create_state_ref(copy=False)
            obj._state_is_copy = False


def restore(
    obj: Any,
    path: str,
    *,
    strict_shapes: bool = True,
) -> Snapshot:
    """Load ``path`` into the live ``obj``; returns the decoded :class:`Snapshot`.

    Integrity failures raise :class:`CorruptSnapshotError`; schema/structure
    mismatches raise :class:`CkptSchemaError`. Either way the live instance is
    untouched on failure.
    """
    t0 = time.perf_counter()
    with _obs.ckpt_span("ckpt.restore", site="metric", cls=type(obj).__name__):
        with open(path, "rb") as f:
            data = f.read()
        snap = ckpt_format.loads(data)
        tree = migrate(snap, CKPT_SCHEMA_VERSION)
        _validate_tree(obj, tree, strict_shapes=strict_shapes)
        # load_state_dict raises mid-walk on a missing key; roll the instance
        # back so a failed restore never leaves half-applied state behind
        saved = [(m, dict(m.__dict__)) for _, m in _walk_metrics(obj)]
        try:
            _apply_tree(obj, tree)
        except BaseException:
            for m, d in saved:
                m.__dict__.clear()
                m.__dict__.update(d)
            raise
    _obs.record_ckpt_io(
        "metric", "restore", len(data), time.perf_counter() - t0, generation=None
    )
    return snap
