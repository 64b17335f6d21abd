"""Instrumentation hooks of the metric core and the kernel plane
(port of the metric and kernel sections of ``metrics_tpu/obs/instrument.py``).

Every hook returns at once, or hands back a shared no-op, while ``OBS.enabled``
is false. Unlike the JAX package, whose callers are jitted and so count
compiled lowerings, PyTorch runs eagerly: the kernel hooks count calls. The
JAX package's op timer also opens a trace span; the port has no tracer yet,
so its timer records the wall-time histogram only.
"""

from __future__ import annotations

import itertools
import time
from typing import Any

from metrics_tpu_torch.obs.registry import OBS, REGISTRY

OP_SECONDS = REGISTRY.histogram(
    "metrics_tpu_torch_op_seconds",
    "Wall time of metric operations (op=update|compute|sync), per metric class and instance.",
)

KERNEL_DISPATCHES = REGISTRY.counter(
    "metrics_tpu_torch_kernel_dispatch_total",
    "Kernel-plane registry dispatches per entry and impl (optimized|reference), one per call.",
)
KERNEL_LAUNCHES = REGISTRY.counter(
    "metrics_tpu_torch_kernel_launches_total",
    "CUDA kernel launches per kernel, counted by the wrapper where it launches.",
)


# Bounded per-instance labelling: the registry never evicts, so the label is a
# monotone issue number stored on the object, and instances past the cap share
# one overflow label (per-class series stay exact).
_INSTANCE_CAP = 256
_INSTANCE_ATTR = "_obs_instance_label"
_instance_ids = itertools.count()


def instance_label(obj: Any) -> str:
    """Stable-for-the-lifetime-of-the-object instance id label (bounded set)."""
    label = getattr(obj, _INSTANCE_ATTR, None)
    if label is not None:
        return label
    n = next(_instance_ids)
    label = str(n) if n < _INSTANCE_CAP else "overflow"
    try:
        object.__setattr__(obj, _INSTANCE_ATTR, label)
    except (AttributeError, TypeError):  # slotted or immutable hosts: don't burn cap slots on them
        return "untracked"
    return label


class _NullOp:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self) -> "_NullOp":
        return self

    def __exit__(self, *exc_info: Any) -> bool:
        return False


_NULL_OP = _NullOp()


class _OpTimer:
    """Wall-time histogram around one metric operation."""

    __slots__ = ("_op", "_metric", "_instance", "_t0")

    def __init__(self, op: str, metric: str, instance: str) -> None:
        self._op = op
        self._metric = metric
        self._instance = instance

    def __enter__(self) -> "_OpTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        OP_SECONDS.observe(time.perf_counter() - self._t0, op=self._op, metric=self._metric, instance=self._instance)
        return False


def metric_op(op: str, owner: Any) -> Any:
    """Context manager timing one ``update``/``compute``/``sync`` on ``owner``.

    Returns a shared no-op when the master switch is off. The time is the
    host's: PyTorch returns before the card finishes, so on a GPU it is the
    time to enqueue the work unless the operation waits for the card.
    """
    if not OBS.enabled:
        return _NULL_OP
    return _OpTimer(op, type(owner).__name__, instance_label(owner))


def record_kernel_dispatch(name: str, impl: str) -> None:
    """Count one registry dispatch of entry ``name`` to ``impl``."""
    if not OBS.enabled:
        return
    KERNEL_DISPATCHES.inc(1, kernel=name, impl=impl)


def record_kernel_launch(name: str) -> None:
    """Count one launch of CUDA kernel ``name``."""
    if not OBS.enabled:
        return
    KERNEL_LAUNCHES.inc(1, kernel=name)
