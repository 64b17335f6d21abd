"""Carry parameters and metric states from the JAX package into the port.

Every function takes plain numpy trees (``np.asarray`` of every JAX leaf), so
nothing here imports JAX. Leaves are copied: arrays exported by JAX are read-only.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List, Mapping, Optional, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.utils.device import DeviceLike, resolve_device


def params_from_jax(tree_of_numpy: Mapping[str, Any], device: DeviceLike = None) -> Dict[str, Union[Tensor, List[Tensor]]]:
    """The flagship MLP's parameters (``{"ws": [w, ...], "head": w}``) as float32 tensors.

    The JAX layout is kept: every weight is ``(fan_in, fan_out)`` and applied as
    ``h @ w``, exactly as ``bench.py`` applies it, so no weight is transposed.
    """
    dev = resolve_device(device)

    def conv(x: Any) -> Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32, copy=True)).to(dev)

    return {k: [conv(w) for w in v] if isinstance(v, (list, tuple)) else conv(v) for k, v in tree_of_numpy.items()}


def metric_state_from_jax(state_of_numpy: Mapping[str, Any], device: DeviceLike = None) -> Dict[str, Any]:
    """A functional metric state (``Metric.init_state()`` layout) as tensors.

    Dtypes are kept as they are, so int32 counts and ``_update_count`` stay
    int32; list states become lists of tensors.
    """
    dev = resolve_device(device)

    def conv(x: Any) -> Tensor:
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return {k: [conv(v) for v in val] if isinstance(val, (list, tuple)) else conv(val) for k, val in state_of_numpy.items()}


def _like(template: Any, tree: Any, device: torch.device) -> Any:
    """``tree`` (numpy leaves) as tensors in ``template``'s structure, dicts
    matched by key (the JAX package orders dict leaves by key, the port by
    insertion)."""
    if isinstance(template, dict):
        return {k: _like(template[k], tree[k], device) for k in template}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def keyed_state_from_jax(
    keyed: Any,
    slots: Mapping[Hashable, int],
    states: Optional[Mapping[Hashable, Any]] = None,
    stacked: Optional[Any] = None,
) -> None:
    """Load a JAX engine's tenants into a port ``KeyedState`` at the same slots.

    ``slots`` is the JAX ``KeyedState._slots`` (key -> slot id). The states come
    as numpy trees, either per key (``states``: ``state_of(key)`` of each key)
    or as the stacked slab (``stacked``: ``KeyedState.stacked``, indexed by slot
    id). Each key is installed at its JAX slot id, the slab grows to hold them,
    and each row is written in place.
    """
    if (states is None) == (stacked is None):
        raise ValueError("pass exactly one of `states` (per key) or `stacked` (the slab)")
    for key, slot in slots.items():
        keyed.install_slot(key, slot)
    keyed.ensure_capacity()
    template = keyed._metric.init_state()
    device = keyed.leaves()[0].device
    for key, slot in slots.items():
        tree = states[key] if states is not None else _row(stacked, int(slot))
        keyed.set_state(key, _like(template, tree, device))


def _row(stacked: Any, slot: int) -> Any:
    if isinstance(stacked, dict):
        return {k: _row(v, slot) for k, v in stacked.items()}
    return np.asarray(stacked)[slot]
