"""Core ``Metric`` runtime (port of ``metrics_tpu/metric.py``).

A metric holds named states: tensors on one explicit device (fixed-shape
states) or Python lists of tensors (ragged "cat" states). Updates rebind
states to new tensors and never write into a state in place, so a snapshot is
a set of references, as it is with the JAX package's immutable arrays.

Two faces over the same states:

- the stateful shell, ``update()`` / ``compute()`` / ``forward()`` /
  ``reset()``, with cross-process sync through ``gather_all_tensors``;
- the pure functional API, ``init_state()`` / ``update_state(state, ...)`` /
  ``compute_from(state)`` / ``merge_states(a, b)``, which a training step calls
  with states it owns. ``update_state`` does not modify the state it is given.

The device is explicit: ``device=None`` means the GPU, and constructing a
metric without one raises unless ``device="cpu"`` (or another device) is given.
Count states and the functional ``_update_count`` are int32, as in the JAX
package with x64 off.

The arithmetic and comparison operators on a metric build a
:class:`CompositionalMetric`, as in the JAX package. So ``m1 == m2`` is a
metric, not a bool: code that compares metrics compares them by identity.

``jitted_update_state`` is the serving engine's hook, as in the JAX package:
there ``jax.jit`` compiles the pure updater; here the updater is captured as a
CUDA graph per operand shape and dtype (on the CPU it is ``update_state``).

``save``/``restore`` write and read an MTCKPT1 snapshot of every state
(:mod:`metrics_tpu_torch.ckpt`), which the JAX package reads too. Not ported
yet: in-trace ``sync_state`` and ``compute_from`` with an ``axis_name`` (they
wait for the comm plane).
"""

from __future__ import annotations

import functools
import inspect
import operator
from abc import ABC, abstractmethod
from contextlib import contextmanager
from copy import deepcopy
from typing import Any, Callable, Dict, Generator, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from metrics_tpu_torch.obs import instrument as _obs
from metrics_tpu_torch.obs.registry import OBS as _OBS
from metrics_tpu_torch.utils.checks import traced
from metrics_tpu_torch.utils.data import (
    _flatten,
    _squeeze_if_scalar,
    apply_to_collection,
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
)
from metrics_tpu_torch.utils.device import DeviceLike, resolve_device
from metrics_tpu_torch.utils.distributed import distributed_available, gather_all_tensors
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from metrics_tpu_torch.utils.graphs import capture
from metrics_tpu_torch.utils.prints import rank_zero_warn

_REDUCTION_FNS: Dict[str, Callable] = {
    "sum": dim_zero_sum,
    "mean": dim_zero_mean,
    "cat": dim_zero_cat,
    "min": dim_zero_min,
    "max": dim_zero_max,
}

StateValue = Union[Tensor, List[Tensor]]


def zero_state(shape: Any = (), dtype: torch.dtype = torch.float32, device: DeviceLike = None) -> Tensor:
    """An all-zeros state default of ``shape`` and ``dtype`` on ``device``."""
    if isinstance(shape, int):
        shape = (shape,)
    return torch.zeros(tuple(shape), dtype=dtype, device=resolve_device(device))


def _raise_on_unconsumed(state_dict: Dict[str, Any], prefix: str, consumed: set) -> None:
    """Strict-mode guard: any key under ``prefix`` that was not consumed is unexpected."""
    unexpected = sorted(k for k in state_dict if k.startswith(prefix) and k not in consumed)
    if unexpected:
        shown = ", ".join(unexpected[:8]) + (" ..." if len(unexpected) > 8 else "")
        raise KeyError(f"Unexpected key(s) in state_dict under prefix {prefix!r}: {shown}")


def _copy_state(value: StateValue) -> StateValue:
    return list(value) if isinstance(value, list) else value.clone()


def _as_state_tensor(value: Any, device: torch.device) -> Tensor:
    """A tensor on ``device`` from a tensor or an array (numpy arrays are
    copied: those exported by other frameworks are read-only)."""
    if isinstance(value, Tensor):
        return value.to(device)
    return torch.from_numpy(np.array(value, copy=True)).to(device)


class _GraphedUpdater:
    """``obj.update_state`` captured as one CUDA graph per operand structure,
    shapes and dtypes (the JAX package's ``jax.jit(update_state)``).

    A call whose tensors lie on the CPU runs ``update_state`` itself. On the card
    the first call of a shape copies the operands into static buffers, runs the
    update once (building the kernels and settling the allocator), captures it
    and replays; later calls copy the operands in and replay. With ``donate``
    the result is the graph's own output buffers, valid until the next call of
    the same shapes (the caller hands the state back in, as with a donated JAX
    buffer); without it, copies of them. A capture that fails raises.

    Every run stands for the JAX package's traced updater, so each (the CPU
    path, the warm-up and the capture) runs
    :func:`~metrics_tpu_torch.utils.checks.traced`: value checks are skipped,
    as a trace skips them, and a call is judged the same on the CPU and on the
    card, before its graph exists and after.
    """

    def __init__(self, obj: Any, donate: bool) -> None:
        self._obj = obj
        self._donate = donate
        self._graphs: Dict[Any, Tuple[torch.cuda.CUDAGraph, List[Tensor], Any]] = {}

    def __call__(self, state: Any, *args: Any, **kwargs: Any) -> Any:
        leaves, spec = tree_flatten((state, args, kwargs))
        if not any(isinstance(x, Tensor) and x.is_cuda for x in leaves):
            with traced():
                return self._obj.update_state(state, *args, **kwargs)
        key = (spec, tuple((tuple(x.shape), x.dtype, x.device) if isinstance(x, Tensor) else x for x in leaves))
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._capture(leaves, spec)
            self._graphs[key] = entry
        graph, static_in, static_out = entry
        for dst, src in zip(static_in, leaves):
            if isinstance(dst, Tensor):
                dst.copy_(src)
        graph.replay()
        return static_out if self._donate else tree_map(lambda x: x.clone(), static_out)

    def _capture(self, leaves: List[Any], spec: Any) -> Tuple[torch.cuda.CUDAGraph, List[Any], Any]:
        static_in = [x.clone() if isinstance(x, Tensor) else x for x in leaves]

        def run() -> Any:
            state, args, kwargs = tree_unflatten(static_in, spec)
            return self._obj.update_state(state, *args, **kwargs)

        device = next(x.device for x in static_in if isinstance(x, Tensor) and x.is_cuda)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with traced():
            with torch.cuda.stream(stream):
                run()  # warm-up: kernels built, allocator settled
            torch.cuda.current_stream(device).wait_stream(stream)
            graph, static_out = capture(run, stream)
        return graph, static_in, static_out


def _cached_graphed_updater(obj: Any, donate: bool) -> Callable:
    """Shared body of ``{Metric,MetricCollection}.jitted_update_state``: one
    updater per (instance, donate flag), cached under ``_jitted_update_state``
    (dropped by ``__getstate__``: graphs neither pickle nor deepcopy)."""
    cache = obj.__dict__.setdefault("_jitted_update_state", {})
    fn = cache.get(donate)
    if fn is None:
        fn = cache[donate] = _GraphedUpdater(obj, donate)
    return fn


class Metric(ABC):
    """Base class for all metrics.

    Kwargs: ``device`` (default: the GPU), ``compute_on_cpu``,
    ``dist_sync_on_step``, ``process_group``, ``dist_sync_fn``,
    ``distributed_available_fn``, ``sync_on_compute``.
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = False
    # Metric.plot() bounds and legend; subclasses with a known value range override them
    plot_lower_bound: Optional[float] = None
    plot_upper_bound: Optional[float] = None
    plot_legend_name: Optional[str] = None
    # compute runs on the host (data-dependent shapes): the streaming engine serves
    # such a metric on its eager path, never stacked
    _host_compute: bool = False

    def __init__(self, **kwargs: Any) -> None:
        self._device = resolve_device(kwargs.pop("device", None))

        self.compute_on_cpu = kwargs.pop("compute_on_cpu", False)
        if not isinstance(self.compute_on_cpu, bool):
            raise ValueError(f"Expected keyword argument `compute_on_cpu` to be a `bool` but got {self.compute_on_cpu}")

        self.dist_sync_on_step = kwargs.pop("dist_sync_on_step", False)
        if not isinstance(self.dist_sync_on_step, bool):
            raise ValueError(f"Expected keyword argument `dist_sync_on_step` to be a `bool` but got {self.dist_sync_on_step}")

        self.process_group = kwargs.pop("process_group", None)

        self.dist_sync_fn = kwargs.pop("dist_sync_fn", None)
        if self.dist_sync_fn is not None and not callable(self.dist_sync_fn):
            raise ValueError(f"Expected keyword argument `dist_sync_fn` to be an callable function but got {self.dist_sync_fn}")

        self.distributed_available_fn = kwargs.pop("distributed_available_fn", None) or distributed_available

        self.sync_on_compute = kwargs.pop("sync_on_compute", True)
        if not isinstance(self.sync_on_compute, bool):
            raise ValueError(f"Expected keyword argument `sync_on_compute` to be a `bool` but got {self.sync_on_compute}")

        if kwargs:
            kwargs_ = [f"`{a}`" for a in sorted(kwargs)]
            raise ValueError(f"Unexpected keyword arguments: {', '.join(kwargs_)}")

        self._defaults: Dict[str, StateValue] = {}
        self._persistent: Dict[str, bool] = {}
        self._reductions: Dict[str, Union[str, Callable, None]] = {}

        self._update_count = 0
        self._computed: Any = None
        self._to_sync = self.sync_on_compute
        self._should_unsync = True

        self._cache: Optional[Dict[str, StateValue]] = None
        self._is_synced = False

        self._update_called = False
        self._forward_cache: Any = None
        self._batch_state: Optional[Dict[str, StateValue]] = None

        self.update: Callable = self._wrap_update(self.update)  # type: ignore[method-assign]
        self.compute: Callable = self._wrap_compute(self.compute)  # type: ignore[method-assign]

    @property
    def device(self) -> torch.device:
        return self._device

    # ------------------------------------------------------------------ state registry

    def add_state(
        self,
        name: str,
        default: Union[Tensor, np.ndarray, list],
        dist_reduce_fx: Optional[Union[str, Callable]] = None,
        persistent: bool = False,
    ) -> None:
        """Register a metric state.

        ``default`` must be a tensor (fixed-shape state) or an empty list
        (ragged "cat" state). ``dist_reduce_fx`` is one of 'sum', 'mean',
        'cat', 'min', 'max', a callable, or None.
        """
        if not isinstance(default, (Tensor, np.ndarray, list)) or (isinstance(default, list) and default):
            raise ValueError("state variable must be a tensor or any empty list (where you can append tensors)")
        if isinstance(dist_reduce_fx, str):
            if dist_reduce_fx not in _REDUCTION_FNS:
                raise ValueError("`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'min', 'max', None]")
        elif not (callable(dist_reduce_fx) or dist_reduce_fx is None):
            raise ValueError("`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'min', 'max', None]")
        if name in ("_defaults", "_persistent", "_reductions", "update", "compute"):
            raise ValueError(f"The name `{name}` is reserved and cannot be used for a metric state")

        if not isinstance(default, list):
            default = _as_state_tensor(default, self._device)
        self._defaults[name] = default
        setattr(self, name, _copy_state(default))
        self._persistent[name] = persistent
        self._reductions[name] = dist_reduce_fx

    # ------------------------------------------------------------------ update/compute (stateful shell)

    @abstractmethod
    def update(self, *args: Any, **kwargs: Any) -> None:
        """Override to update metric state from a batch."""

    @abstractmethod
    def compute(self) -> Any:
        """Override to compute the final value from accumulated state."""

    def _wrap_update(self, update: Callable) -> Callable:
        @functools.wraps(update)
        def wrapped_func(*args: Any, **kwargs: Any) -> None:
            self._computed = None
            self._update_count += 1
            self._update_called = True
            if self._is_synced:
                raise MetricsTPUUserError(
                    "The Metric has already been synced. HINT: call `unsync()` before modifying the state."
                )
            if _OBS.enabled:
                with _obs.metric_op("update", self):
                    update(*args, **kwargs)
            else:
                update(*args, **kwargs)
            if self.compute_on_cpu:
                self._move_list_states_to_cpu()

        return wrapped_func

    def _move_list_states_to_cpu(self) -> None:
        """Move the entries of list states to host memory."""
        for key in self._defaults:
            current = getattr(self, key)
            if isinstance(current, list):
                setattr(self, key, [c.cpu() if isinstance(c, Tensor) else c for c in current])

    def _wrap_compute(self, compute: Callable) -> Callable:
        @functools.wraps(compute)
        def wrapped_func(*args: Any, **kwargs: Any) -> Any:
            if not self._update_called:
                rank_zero_warn(
                    f"The ``compute`` method of metric {self.__class__.__name__} was called before the ``update`` method"
                    " which may lead to errors, as metric states have not yet been updated.",
                    UserWarning,
                )
            if self._computed is not None:
                return self._computed
            with _obs.metric_op("compute", self):
                with self.sync_context(
                    dist_sync_fn=self.dist_sync_fn,
                    process_group=self.process_group,
                    should_sync=self._to_sync,
                    should_unsync=self._should_unsync,
                ):
                    self._computed = _squeeze_if_scalar(compute(*args, **kwargs))
            return self._computed

        return wrapped_func

    def _snapshot_state(self) -> Dict[str, StateValue]:
        """Shallow snapshot: tensor references plus shallow list copies."""
        return {attr: (list(v) if isinstance(v, list) else v) for attr, v in ((a, getattr(self, a)) for a in self._defaults)}

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate global state AND return the metric value on this batch."""
        if self._is_synced:
            raise MetricsTPUUserError("The Metric shouldn't be synced when performing ``forward``.")
        if self.full_state_update or self.full_state_update is None or self.dist_sync_on_step:
            return self._forward_full_state_update(*args, **kwargs)
        return self._forward_reduce_state_update(*args, **kwargs)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def _restore_after_forward(self, batch_val: Any) -> None:
        self._is_synced = False
        self._cache = None
        self._should_unsync = True
        self._to_sync = self.sync_on_compute
        self._computed = None
        self._forward_cache = batch_val

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """Two updates: one into the global state, one into a fresh state for the batch value."""
        self.update(*args, **kwargs)
        _update_count = self._update_count
        self._to_sync = self.dist_sync_on_step
        cache = self._snapshot_state()
        self._should_unsync = False
        self.reset()
        self.update(*args, **kwargs)
        self._batch_state = self._snapshot_state()
        batch_val = self.compute()
        for attr, val in cache.items():
            setattr(self, attr, val)
        self._update_count = _update_count
        self._restore_after_forward(batch_val)
        return batch_val

    def _forward_reduce_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """One update into a fresh state, then an associative merge into the global state."""
        global_state = self._snapshot_state()
        _update_count = self._update_count
        self.reset()
        self._to_sync = self.dist_sync_on_step
        self._should_unsync = False
        self.update(*args, **kwargs)
        self._batch_state = self._snapshot_state()
        batch_val = self.compute()
        self._update_count = _update_count + 1
        self._reduce_states(global_state)
        self._restore_after_forward(batch_val)
        return batch_val

    def _compute_batch_value(self, batch_state: Dict[str, StateValue]) -> Any:
        """This metric's per-batch forward value from a batch-only state that
        another metric supplies (a compute-group leader's ``_batch_state``).

        MetricCollection's grouped ``forward`` uses it: a group member shares
        its leader's state evolution, so its batch value is its own ``compute``
        over the leader's batch state, with no second update. This metric's
        global state is left as it was (the collection aliases it from the
        leader at the next read).
        """
        saved = {attr: getattr(self, attr) for attr in self._defaults}
        saved_count = self._update_count
        for attr, val in batch_state.items():
            setattr(self, attr, val)
        self._update_count = 1
        self._update_called = True
        self._to_sync = self.dist_sync_on_step
        self._should_unsync = False
        self._computed = None
        batch_val = None
        try:
            batch_val = self.compute()
        finally:
            for attr, val in saved.items():
                setattr(self, attr, val)
            self._update_count = saved_count
            self._restore_after_forward(batch_val)
        return batch_val

    def _reduce_states(self, incoming_state: Dict[str, StateValue]) -> None:
        """Merge an incoming (global) state into the current (batch) state.

        sum: add; mean: running mean by update count; max/min: elementwise;
        cat: list concat; None: stack.
        """
        for attr in self._defaults:
            local_state = getattr(self, attr)
            global_state = incoming_state[attr]
            reduce_fn = self._reductions[attr]
            if reduce_fn == "sum":
                reduced = global_state + local_state
            elif reduce_fn == "mean":
                reduced = ((self._update_count - 1) * global_state + local_state) / self._update_count
            elif reduce_fn == "max":
                reduced = torch.maximum(global_state, local_state)
            elif reduce_fn == "min":
                reduced = torch.minimum(global_state, local_state)
            elif reduce_fn == "cat":
                reduced = global_state + local_state  # list concat
            elif reduce_fn is None and isinstance(global_state, Tensor):
                reduced = torch.stack([global_state, local_state])
            elif reduce_fn is None and isinstance(global_state, list):
                reduced = _flatten([global_state, local_state])
            else:
                reduced = reduce_fn(torch.stack([global_state, local_state]))
            setattr(self, attr, reduced)

    # ------------------------------------------------------------------ distributed sync (host level)

    def _sync_dist(self, dist_sync_fn: Callable = gather_all_tensors, process_group: Optional[Any] = None) -> None:
        """Gather every registered state from all ranks, then reduce it."""
        input_dict = {attr: getattr(self, attr) for attr in self._reductions}
        for attr in self._reductions:
            # pre-concatenate list states to need one gather each
            if isinstance(input_dict[attr], list) and len(input_dict[attr]) >= 1:
                input_dict[attr] = [dim_zero_cat(input_dict[attr])]

        output_dict = apply_to_collection(input_dict, Tensor, dist_sync_fn, group=process_group or self.process_group)

        for attr, reduction_fn in self._reductions.items():
            if isinstance(output_dict[attr], list) and len(output_dict[attr]) == 0:
                setattr(self, attr, [])
                continue
            if isinstance(output_dict[attr][0], Tensor):
                output_dict[attr] = torch.stack(output_dict[attr])
            elif isinstance(output_dict[attr][0], list):
                output_dict[attr] = _flatten(output_dict[attr])
            fn = _REDUCTION_FNS.get(reduction_fn, reduction_fn) if isinstance(reduction_fn, str) else reduction_fn
            if not (callable(fn) or fn is None):
                raise TypeError("reduction_fn must be callable or None")
            reduced = fn(output_dict[attr]) if fn is not None else output_dict[attr]
            if isinstance(getattr(self, attr), list) and isinstance(reduced, Tensor):
                reduced = [reduced]
            setattr(self, attr, reduced)

    def sync(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        distributed_available: Optional[Callable] = None,
    ) -> None:
        """Sync state across processes, keeping the local state to restore on ``unsync``."""
        if self._is_synced and should_sync:
            raise MetricsTPUUserError("The Metric has already been synced.")
        if distributed_available is None and self.distributed_available_fn is not None:
            distributed_available = self.distributed_available_fn
        is_distributed = distributed_available() if callable(distributed_available) else None
        if not should_sync or not is_distributed:
            return
        if dist_sync_fn is None:
            dist_sync_fn = gather_all_tensors
        self._cache = self._snapshot_state()
        with _obs.metric_op("sync", self):
            self._sync_dist(dist_sync_fn, process_group=process_group)
        self._is_synced = True

    def unsync(self, should_unsync: bool = True) -> None:
        """Restore the local state cached by ``sync``."""
        if not should_unsync:
            return
        if not self._is_synced:
            raise MetricsTPUUserError("The Metric has already been un-synced.")
        if self._cache is None:
            raise MetricsTPUUserError("The internal cache should exist to unsync the Metric.")
        for attr, val in self._cache.items():
            setattr(self, attr, val)
        self._is_synced = False
        self._cache = None

    @contextmanager
    def sync_context(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        should_unsync: bool = True,
        distributed_available: Optional[Callable] = None,
    ) -> Generator[None, None, None]:
        """Sync on enter, unsync on exit."""
        self.sync(
            dist_sync_fn=dist_sync_fn,
            process_group=process_group,
            should_sync=should_sync,
            distributed_available=distributed_available,
        )
        yield
        self.unsync(should_unsync=self._is_synced and should_unsync)

    # ------------------------------------------------------------------ pure functional API

    def _raw_update(self) -> Callable:
        """The unwrapped subclass ``update``."""
        return type(self).update.__get__(self)

    def _raw_compute(self) -> Callable:
        return type(self).compute.__get__(self)

    def init_state(self) -> Dict[str, Any]:
        """Default state as a dict of fresh tensors (and empty lists), with an
        int32 ``_update_count``."""
        state: Dict[str, Any] = {name: _copy_state(default) for name, default in self._defaults.items()}
        state["_update_count"] = torch.zeros((), dtype=torch.int32, device=self._device)
        return state

    def _swap_in(self, state: Dict[str, Any]) -> Dict[str, Any]:
        snapshot: Dict[str, Any] = {name: getattr(self, name) for name in self._defaults}
        snapshot["_update_count"] = self._update_count
        for name in self._defaults:
            value = state[name]
            # a list state is appended to by update: copy it, so the caller's list is untouched
            setattr(self, name, list(value) if isinstance(value, list) else value)
        self._update_count = state.get("_update_count", 0)
        return snapshot

    def _swap_out(self, snapshot: Dict[str, Any]) -> Dict[str, Any]:
        state: Dict[str, Any] = {name: getattr(self, name) for name in self._defaults}
        state["_update_count"] = self._update_count
        for name in self._defaults:
            setattr(self, name, snapshot[name])
        self._update_count = snapshot["_update_count"]
        return state

    def update_state(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Pure: ``(state, batch) -> new state``; ``state`` itself is left as it was."""
        snapshot = self._swap_in(state)
        try:
            self._raw_update()(*args, **kwargs)
            self._update_count = self._update_count + 1
        finally:
            new_state = self._swap_out(snapshot)
        return new_state

    def compute_from(self, state: Dict[str, Any], axis_name: Optional[Any] = None) -> Any:
        """Pure: the final value from a state dict.

        ``axis_name`` (the JAX package's in-trace sync over mesh axes) is not
        ported yet: it waits for the comm plane (ROADMAP A.8), and a non-None
        value raises.
        """
        if axis_name is not None:
            raise NotImplementedError(
                "compute_from(state, axis_name=...) syncs through the comm plane, which is not ported yet "
                "(ROADMAP A.8); sync host-side with sync()/compute() instead"
            )
        snapshot = self._swap_in(state)
        try:
            return _squeeze_if_scalar(self._raw_compute()())
        finally:
            self._swap_out(snapshot)

    def jitted_update_state(self, donate: bool = True) -> Callable:
        """The pure updater captured as a CUDA graph per operand shape and dtype
        (the JAX package's jitted updater; ``update_state`` itself for CPU
        tensors): ``state = updater(state, preds, target)``.

        The serving engine's hook: a runtime that owns its state exclusively can
        donate it (``donate=True``), and must not touch a donated state
        afterwards — the updater returns its graph's output buffers, which the
        next call of the same shapes overwrites. The cache is per instance.
        """
        return _cached_graphed_updater(self, donate)

    def merge_states(self, state_a: Dict[str, Any], state_b: Dict[str, Any]) -> Dict[str, Any]:
        """Associatively merge two state dicts (pure analogue of ``_reduce_states``)."""
        merged: Dict[str, Any] = {}
        count_a = state_a.get("_update_count", 0)
        count_b = state_b.get("_update_count", 0)
        total = count_a + count_b
        for name, reduction in self._reductions.items():
            a, b = state_a[name], state_b[name]
            if reduction == "sum":
                merged[name] = a + b
            elif reduction == "mean":
                merged[name] = (count_a * a + count_b * b) / torch.clamp(torch.as_tensor(total), min=1)
            elif reduction == "max":
                merged[name] = torch.maximum(a, b)
            elif reduction == "min":
                merged[name] = torch.minimum(a, b)
            elif reduction == "cat" or reduction is None:
                merged[name] = list(a) + list(b) if isinstance(a, list) else torch.cat([a, b], dim=0)
            else:
                merged[name] = reduction(torch.stack([a, b]))
        merged["_update_count"] = total
        return merged

    # ------------------------------------------------------------------ reset / clone

    def reset(self) -> None:
        """Reset states to their defaults."""
        self._update_count = 0
        self._update_called = False
        self._computed = None
        self._batch_state = None
        for attr, default in self._defaults.items():
            setattr(self, attr, _copy_state(default))
        self._cache = None
        self._is_synced = False

    def clone(self) -> "Metric":
        """Deep copy of the metric."""
        return deepcopy(self)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        """Plot a single computed value or a list of values as a time series.

        With ``val=None`` the current ``compute()`` result is plotted. Needs
        matplotlib; returns ``(fig, ax)``.
        """
        from metrics_tpu_torch.utils.plot import plot_single_or_multi_val

        val = val if val is not None else self.compute()
        return plot_single_or_multi_val(
            val,
            ax=ax,
            higher_is_better=self.higher_is_better,
            lower_bound=self.plot_lower_bound,
            upper_bound=self.plot_upper_bound,
            legend_name=self.plot_legend_name,
            name=self.__class__.__name__,
        )

    def _map_states(self, fn: Callable[[Tensor], Tensor]) -> None:
        """Apply ``fn`` to every tensor of the states and of their defaults."""

        def _apply(value: StateValue) -> StateValue:
            return [fn(v) for v in value] if isinstance(value, list) else fn(value)

        for attr in self._defaults:
            setattr(self, attr, _apply(getattr(self, attr)))
        self._defaults = {k: _apply(v) for k, v in self._defaults.items()}

    def to_device(self, device: DeviceLike) -> "Metric":
        """Move all states (and defaults) to ``device``."""
        self._device = resolve_device(device)
        self._map_states(lambda x: x.to(self._device))
        return self

    def set_dtype(self, dst_type: torch.dtype) -> "Metric":
        """Convert the floating-point states (and defaults) to ``dst_type``."""
        self._map_states(lambda x: x.to(dst_type) if x.is_floating_point() else x)
        return self

    # ------------------------------------------------------------------ persistence

    def _child_metrics(self) -> Generator[Tuple[str, "Metric"], None, None]:
        """Directly held child metrics (compositional operands, wrapped bases),
        as ``(attr_path, metric)`` pairs: their states go through ``state_dict``
        and ``persistent`` with this metric's."""
        for name, val in self.__dict__.items():
            if isinstance(val, Metric):
                yield name, val
            elif isinstance(val, (list, tuple)):
                for i, v in enumerate(val):
                    if isinstance(v, Metric):
                        yield f"{name}.{i}", v

    def persistent(self, mode: bool = False) -> None:
        """Set the persistence of all states, the child metrics' included."""
        for key in self._persistent:
            self._persistent[key] = mode
        for _name, child in self._child_metrics():
            child.persistent(mode)

    def _any_persistent(self) -> bool:
        """True if any state here or in any nested child metric is persistent."""
        if any(self._persistent.values()):
            return True
        return any(child._any_persistent() for _name, child in self._child_metrics())

    def state_dict(self, destination: Optional[Dict] = None, prefix: str = "") -> Dict[str, Any]:
        """Persistent states (only those registered ``persistent=True``) as a
        flat dict of detached tensor copies (lists of them for list states),
        the child metrics' under ``"<attr>."``."""
        destination = {} if destination is None else destination
        for key in self._defaults:
            if not self._persistent[key]:
                continue
            current = getattr(self, key)
            if isinstance(current, list):
                destination[prefix + key] = [c.detach().clone() if isinstance(c, Tensor) else c for c in current]
            else:
                destination[prefix + key] = current.detach().clone()
        for name, child in self._child_metrics():
            child.state_dict(destination, prefix=f"{prefix}{name}.")
        return destination

    def load_state_dict(
        self,
        state_dict: Dict[str, Any],
        prefix: str = "",
        strict: bool = True,
        _consumed: Optional[set] = None,
    ) -> None:
        """Inverse of :meth:`state_dict`; values may be tensors or numpy arrays.

        ``strict=True`` raises on missing persistent keys and on unexpected keys
        under this instance's prefix. ``_consumed`` is internal: nested metrics
        record the keys they restored, and only the outermost call checks for
        unexpected keys.
        """
        owns_check = _consumed is None
        consumed: set = set() if owns_check else _consumed
        for key in self._defaults:
            name = prefix + key
            if name in state_dict:
                consumed.add(name)
                val = state_dict[name]
                if isinstance(val, list):
                    setattr(self, key, [_as_state_tensor(v, self._device) for v in val])
                else:
                    setattr(self, key, _as_state_tensor(val, self._device))
            elif strict and self._persistent[key]:
                raise KeyError(f"Missing key {name} in state_dict")
        for name, child in self._child_metrics():
            child.load_state_dict(state_dict, prefix=f"{prefix}{name}.", strict=strict, _consumed=consumed)
        if owns_check and strict:
            _raise_on_unconsumed(state_dict, prefix, consumed)

    def save(self, path: str, *, policy: Any = None, meta: Optional[Dict[str, Any]] = None) -> None:
        """Persist this metric's FULL state to ``path`` — atomic, checksummed,
        lossless by default (see :mod:`metrics_tpu_torch.ckpt`).

        Unlike :meth:`state_dict` (reference-parity: persistent states only),
        ``save`` captures every registered state plus update counts, so
        ``restore`` on a fresh instance reproduces ``compute()`` bit-identically.
        ``policy`` opts into the codecs' lossy encodings (counts stay exact).
        """
        from metrics_tpu_torch.ckpt import save as _ckpt_save

        _ckpt_save(self, path, policy=policy, meta=meta)

    def restore(self, path: str) -> Any:
        """Load a :meth:`save` snapshot (of either package) into this instance,
        each state a tensor on this metric's device.

        Strict: integrity (CRC) failures raise
        :class:`~metrics_tpu_torch.ckpt.CorruptSnapshotError`, schema/shape/dtype
        mismatches raise :class:`~metrics_tpu_torch.ckpt.CkptSchemaError`, and
        missing/stray keys raise through the strict ``load_state_dict``
        machinery — in every case this instance is left as it was.
        """
        from metrics_tpu_torch.ckpt import restore as _ckpt_restore

        return _ckpt_restore(self, path)

    def __getstate__(self) -> Dict[str, Any]:
        """Drop the instance-wrapped ``update``/``compute`` for pickling and
        deepcopy, the captured updaters (graphs neither pickle nor deepcopy;
        a clone captures its own), and the obs instance label, so that a clone
        gets its own telemetry series."""
        drop = ("update", "compute", "_jitted_update_state", "_obs_instance_label")
        return {k: v for k, v in self.__dict__.items() if k not in drop}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self.update = self._wrap_update(type(self).update.__get__(self))
        self.compute = self._wrap_compute(type(self).compute.__get__(self))

    def __setattr__(self, name: str, value: Any) -> None:
        if name in ("higher_is_better", "is_differentiable", "full_state_update"):
            raise RuntimeError(f"Can't change const `{name}`.")
        super().__setattr__(name, value)

    # ------------------------------------------------------------------ misc protocol

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """The kwargs that the (unwrapped) ``update`` signature takes; all of
        them if it takes ``**kwargs``."""
        _params = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
        _sign_params = self._update_signature.parameters
        if any(v.kind == inspect.Parameter.VAR_KEYWORD for v in _sign_params.values()):
            return kwargs
        return {k: v for k, v in kwargs.items() if k in _sign_params and _sign_params[k].kind not in _params}

    @property
    def _update_signature(self) -> inspect.Signature:
        return inspect.signature(type(self).update)

    @property
    def metric_state(self) -> Dict[str, StateValue]:
        """Current value of all registered states."""
        return {attr: getattr(self, attr) for attr in self._defaults}

    @property
    def update_called(self) -> bool:
        return self._update_called

    @property
    def update_count(self) -> int:
        return self._update_count

    def __hash__(self) -> int:
        # ``__eq__`` builds a CompositionalMetric, which would drop the default
        # hash; id(self) keeps distinct instances apart
        hash_vals: List[Any] = [self.__class__.__name__, id(self)]
        for key in self._defaults:
            val = getattr(self, key)
            if isinstance(val, list):
                hash_vals.append(id(val))
                hash_vals.extend(id(v) for v in val)
            else:
                hash_vals.append(id(val))
        return hash(tuple(hash_vals))

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}()"

    # Precision is managed explicitly (``set_dtype``); these keep the JAX
    # package's no-op meanings, not ``nn.Module``'s.
    def type(self, dst_type: Any) -> "Metric":  # noqa: A003
        return self

    def float(self) -> "Metric":
        return self

    def double(self) -> "Metric":
        return self

    def half(self) -> "Metric":
        return self

    # ------------------------------------------------------------------ operator overloads -> CompositionalMetric

    def __add__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.add, self, other)

    def __radd__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.add, other, self)

    def __sub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.sub, self, other)

    def __rsub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.sub, other, self)

    def __mul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.mul, self, other)

    def __rmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.mul, other, self)

    def __truediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.truediv, self, other)

    def __rtruediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.truediv, other, self)

    def __floordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.floordiv, self, other)

    def __rfloordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.floordiv, other, self)

    def __mod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.mod, self, other)

    def __rmod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.mod, other, self)

    def __pow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.pow, self, other)

    def __rpow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.pow, other, self)

    def __matmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.matmul, self, other)

    def __rmatmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.matmul, other, self)

    def __and__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.and_, self, other)

    def __rand__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.and_, other, self)

    def __or__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.or_, self, other)

    def __ror__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.or_, other, self)

    def __xor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.xor, self, other)

    def __rxor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.xor, other, self)

    def __lt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.lt, self, other)

    def __le__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.le, self, other)

    def __gt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.gt, self, other)

    def __ge__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.ge, self, other)

    def __eq__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(operator.eq, self, other)

    def __ne__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(operator.ne, self, other)

    def __abs__(self) -> "CompositionalMetric":
        return CompositionalMetric(operator.abs, self, None)

    def __neg__(self) -> "CompositionalMetric":
        return CompositionalMetric(_neg, self, None)

    def __pos__(self) -> "CompositionalMetric":
        return CompositionalMetric(operator.abs, self, None)

    def __inv__(self) -> "CompositionalMetric":
        return CompositionalMetric(operator.inv, self, None)

    __invert__ = __inv__

    def __getitem__(self, idx: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.itemgetter(idx), self, None)

    def __getnewargs__(self) -> tuple:
        return ()


def _neg(x: Tensor) -> Tensor:
    # the JAX package's unary minus (and so the reference's) is -|x|
    return -torch.abs(x)


# Constants an operator captures become tensors of the dtype ``jnp.asarray``
# gives them with x64 off: int32 for a Python int, float32 for a float, and the
# 32-bit type for a 64-bit numpy array.
_NARROWED = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32, np.dtype(np.float64): np.float32,
             np.dtype(np.complex128): np.complex64}


def _operand(value: Any, device: torch.device) -> Any:
    if isinstance(value, bool) or not isinstance(value, (int, float, np.ndarray)):
        return value  # a Metric, a tensor, a bool, None or another object stays as it is
    if isinstance(value, np.ndarray):
        return torch.from_numpy(np.array(value, dtype=_NARROWED.get(value.dtype, value.dtype), copy=True)).to(device)
    return torch.tensor(value, dtype=torch.int32 if isinstance(value, int) else torch.float32, device=device)


class CompositionalMetric(Metric):
    """Lazy composition of metrics through an elementwise operator.

    ``update``/``compute``/``reset``/``persistent`` recurse into the child
    metrics; its own ``_sync_dist`` does nothing (the children sync themselves
    inside their own ``compute``). It lives on its first child metric's device,
    where the constants it captures are put too.

    Built by the operator overloads on :class:`Metric`:

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanMetric
        >>> m1, m2 = MeanMetric(device="cpu"), MeanMetric(device="cpu")
        >>> combo = m1 + 2 * m2
        >>> m1.update(torch.tensor(1.0))
        >>> m2.update(torch.tensor(3.0))
        >>> combo.compute()
        tensor(7.)
    """

    def __init__(
        self,
        operator: Callable,
        metric_a: Union[Metric, float, Tensor, None],
        metric_b: Union[Metric, float, Tensor, None],
    ) -> None:
        device = next((m.device for m in (metric_a, metric_b) if isinstance(m, Metric)), None)
        super().__init__(device=device)
        self.op = operator
        self.metric_a = _operand(metric_a, self.device)
        self.metric_b = _operand(metric_b, self.device)

    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None, process_group: Optional[Any] = None) -> None:
        pass  # No syncing required: children sync themselves.

    def update(self, *args: Any, **kwargs: Any) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.update(*args, **self.metric_a._filter_kwargs(**kwargs))
        if isinstance(self.metric_b, Metric):
            self.metric_b.update(*args, **self.metric_b._filter_kwargs(**kwargs))

    def compute(self) -> Any:
        val_a = self.metric_a.compute() if isinstance(self.metric_a, Metric) else self.metric_a
        val_b = self.metric_b.compute() if isinstance(self.metric_b, Metric) else self.metric_b
        if val_b is None:
            return self.op(val_a)
        return self.op(val_a, val_b)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        val_a = (
            self.metric_a(*args, **self.metric_a._filter_kwargs(**kwargs))
            if isinstance(self.metric_a, Metric)
            else self.metric_a
        )
        val_b = (
            self.metric_b(*args, **self.metric_b._filter_kwargs(**kwargs))
            if isinstance(self.metric_b, Metric)
            else self.metric_b
        )
        if val_a is None:
            self._forward_cache = None
        elif val_b is None:
            self._forward_cache = None if isinstance(self.metric_b, Metric) else self.op(val_a)
        else:
            self._forward_cache = self.op(val_a, val_b)
        return self._forward_cache

    def reset(self) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.reset()
        if isinstance(self.metric_b, Metric):
            self.metric_b.reset()

    def __repr__(self) -> str:
        op_name = self.op.__name__ if hasattr(self.op, "__name__") else self.op
        return f"{self.__class__.__name__}(\n  {op_name}(\n    {self.metric_a!r},\n    {self.metric_b!r}\n  )\n)"

    def _wrap_compute(self, compute: Callable) -> Callable:
        return compute
