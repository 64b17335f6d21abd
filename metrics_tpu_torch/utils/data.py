"""Data manipulation utilities (port of ``metrics_tpu/utils/data.py``)."""

from __future__ import annotations

from collections.abc import Mapping, Sequence
from typing import Any, Callable, List, Union

import torch
from torch import Tensor


def dim_zero_cat(x: Union[Tensor, List[Tensor]]) -> Tensor:
    """Concatenate a (list of) tensor(s) along dim 0."""
    if isinstance(x, Tensor):
        return x
    if not x:  # empty list
        raise ValueError("No samples to concatenate")
    return torch.cat([torch.atleast_1d(torch.as_tensor(y)) for y in x], dim=0)


def dim_zero_sum(x: Tensor) -> Tensor:
    return torch.sum(x, dim=0, dtype=x.dtype)


def dim_zero_mean(x: Tensor) -> Tensor:
    return torch.mean(x, dim=0)


def dim_zero_max(x: Tensor) -> Tensor:
    return torch.amax(x, dim=0)


def dim_zero_min(x: Tensor) -> Tensor:
    return torch.amin(x, dim=0)


def _flatten(x: Sequence) -> list:
    """Flatten list of lists into a single list."""
    return [item for sublist in x for item in sublist]


def _one_hot(labels: Tensor, num_classes: int, dtype: torch.dtype) -> Tensor:
    """One-hot along a new last axis; out-of-range labels give an all-zero row
    (``jax.nn.one_hot`` semantics, where ``torch.nn.functional.one_hot`` raises)."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels.unsqueeze(-1) == classes).to(dtype)


def to_onehot(label_tensor: Tensor, num_classes: int) -> Tensor:
    """Convert dense label tensor ``(N, ...)`` to one-hot ``(N, C, ...)``."""
    dtype = torch.int64 if label_tensor.dtype == torch.int64 else torch.int32
    return torch.movedim(_one_hot(label_tensor, num_classes, dtype), -1, 1)


def _bincount(x: Tensor, minlength: int) -> Tensor:
    """Counts of each value in ``[0, minlength)``, as ``jnp.bincount(x, length=minlength)``
    counts them: negative values count in bin 0 and values at or above
    ``minlength`` are dropped (``torch.bincount`` raises on the one and grows
    past ``minlength`` on the other). int32, as with x64 off."""
    x = x.reshape(-1).to(torch.int64).clamp(min=0)
    kept = torch.where(x < minlength, x, minlength)
    return torch.bincount(kept, minlength=minlength + 1)[:minlength].to(torch.int32)


def select_topk(prob_tensor: Tensor, topk: int = 1, dim: int = 1) -> Tensor:
    """int32 mask of the top-k entries along ``dim``."""
    if topk == 1:  # cheap argmax path
        idx = torch.argmax(prob_tensor, dim=dim, keepdim=True)
    else:
        idx = torch.topk(prob_tensor, topk, dim=dim).indices
    mask = torch.zeros(prob_tensor.shape, dtype=torch.int32, device=prob_tensor.device)
    return mask.scatter_(dim, idx, 1)


def apply_to_collection(data: Any, dtype: Union[type, tuple], function: Callable, *args: Any, **kwargs: Any) -> Any:
    """Recursively apply ``function`` to all elements of type ``dtype``
    (Mapping, NamedTuple and Sequence containers are rebuilt)."""
    elem_type = type(data)
    if isinstance(data, dtype):
        return function(data, *args, **kwargs)
    if isinstance(data, Mapping):
        return elem_type({k: apply_to_collection(v, dtype, function, *args, **kwargs) for k, v in data.items()})
    if isinstance(data, tuple) and hasattr(data, "_fields"):  # namedtuple
        return elem_type(*(apply_to_collection(d, dtype, function, *args, **kwargs) for d in data))
    if isinstance(data, Sequence) and not isinstance(data, str):
        return elem_type([apply_to_collection(d, dtype, function, *args, **kwargs) for d in data])
    return data


def _squeeze_scalar_element_tensor(x: Tensor) -> Tensor:
    return x.squeeze() if x.numel() == 1 else x


def _squeeze_if_scalar(data: Any) -> Any:
    return apply_to_collection(data, Tensor, _squeeze_scalar_element_tensor)
