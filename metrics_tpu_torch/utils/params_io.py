"""Carry parameters and metric states from the JAX package into the port.

Every function takes plain numpy trees (``np.asarray`` of every JAX leaf), so
nothing here imports JAX. Leaves are copied: arrays exported by JAX are read-only.

``save_params`` / ``load_params`` are the JAX package's flat ``.npz`` protocol
for network weights (keys are ``/``-joined flax paths, values the raw arrays),
in numpy only: a weights file written for the JAX package loads here
unchanged. ``inception_params_from_jax`` and ``lpips_params_from_jax`` turn
such a flax tree into the ``state_dict`` of the port's ``nn.Module``.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.utils.device import DeviceLike, resolve_device


def save_params(params: Mapping[str, Any], path: str) -> None:
    """Write a nested dict of arrays (a flax variables tree) as a flat npz, keys
    ``/``-joined paths."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node: Any, prefix: str) -> None:
        if isinstance(node, Mapping):
            for key in sorted(node, key=str):
                walk(node[key], f"{prefix}/{key}" if prefix else str(key))
        else:
            flat[prefix] = node.detach().cpu().numpy() if isinstance(node, Tensor) else np.asarray(node)

    walk(params, "")
    np.savez(path, **flat)


def load_params(path: str) -> Dict[str, Any]:
    """Inverse of :func:`save_params`: a nested dict of numpy arrays."""
    tree: Dict[str, Any] = {}
    with np.load(path) as loaded:
        for key in loaded.files:
            node = tree
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = loaded[key]
    return tree


def _flat(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], np.ndarray]]:
    rows: List[Tuple[Tuple[str, ...], np.ndarray]] = []
    for key, node in tree.items():
        if isinstance(node, Mapping):
            rows += _flat(node, prefix + (str(key),))
        else:
            rows.append((prefix + (str(key),), np.asarray(node)))
    return rows


def _weight(arr: np.ndarray, axes: Tuple[int, ...] = ()) -> Tensor:
    arr = np.asarray(arr, dtype=np.float32)
    return torch.from_numpy(np.array(np.transpose(arr, axes) if axes else arr, order="C", copy=True))


def inception_params_from_jax(variables: Mapping[str, Any]) -> Dict[str, Tensor]:
    """The JAX InceptionV3's variables (``{"params": ..., "batch_stats": ...}``)
    as the ``state_dict`` of :class:`metrics_tpu_torch.image.inception_net.InceptionV3`.

    Conv kernels ``(kh, kw, in, out)`` become ``(out, in, kh, kw)``, the fc
    kernel ``(in, out)`` becomes ``(out, in)``, and BatchNorm's ``scale`` /
    ``bias`` / ``mean`` / ``var`` become ``weight`` / ``bias`` /
    ``running_mean`` / ``running_var``. The keys are torchvision's.
    """
    out: Dict[str, Tensor] = {}
    for path, arr in _flat(variables):
        collection, *modules, leaf = path
        prefix = ".".join(modules)
        if collection == "params" and leaf == "kernel":
            out[f"{prefix}.weight"] = _weight(arr, (3, 2, 0, 1) if arr.ndim == 4 else (1, 0))
        elif collection == "params" and leaf in ("scale", "bias"):
            out[f"{prefix}.{'weight' if leaf == 'scale' else 'bias'}"] = _weight(arr)
        elif collection == "batch_stats" and leaf in ("mean", "var"):
            out[f"{prefix}.running_{leaf}"] = _weight(arr)
        else:
            raise ValueError(f"unexpected InceptionV3 variable {'/'.join(path)}")
    return out


def lpips_params_from_jax(params: Mapping[str, Any], net_type: str) -> Dict[str, Tensor]:
    """The JAX LPIPS net's variables (``{"params": {"features": ..., "lin0":
    ...}}``, or the inner ``params`` dict) as the ``state_dict`` of
    :class:`metrics_tpu_torch.image.lpips_net.LPIPSNet` of ``net_type``.

    Conv kernels ``(kh, kw, in, out)`` become ``(out, in, kh, kw)``; the
    ``(C, 1)`` heads keep their layout. A leaf the net does not hold, or heads
    of other widths than ``net_type``'s, raise ``ValueError``; the backbone's
    missing leaves and wrong shapes are left to ``load_state_dict``.
    """
    from metrics_tpu_torch.image.lpips_net import NET_CHANNELS

    tree = params["params"] if "params" in params else params
    out: Dict[str, Tensor] = {}
    for path, arr in _flat(tree):
        *modules, leaf = path
        prefix = ".".join(modules)
        if modules and modules[0] == "features" and leaf == "kernel" and arr.ndim == 4:
            out[f"{prefix}.weight"] = _weight(arr, (3, 2, 0, 1))
        elif modules and modules[0] == "features" and leaf == "bias":
            out[f"{prefix}.bias"] = _weight(arr)
        elif not modules and leaf.startswith("lin"):
            out[leaf] = _weight(arr)
        else:
            raise ValueError(f"unexpected LPIPS variable {'/'.join(path)}")
    heads = [tuple(out[f"lin{i}"].shape) if f"lin{i}" in out else None for i in range(len(NET_CHANNELS[net_type]))]
    if heads != [(c, 1) for c in NET_CHANNELS[net_type]]:
        raise ValueError(f"the LPIPS heads {heads} are not those of net_type={net_type!r}")
    return out


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
