"""Shared helpers of the per-query retrieval functionals (port of
``metrics_tpu/functional/retrieval/_utils.py``).

Every function is branch-free on the data (``torch.where``, never ``if
target.sum()``), and ``k`` is a Python int. Ranking is by descending score
with a STABLE sort, as ``jnp.argsort`` sorts: tied scores keep their input
order (``torch.argsort`` is unstable unless asked), and -0.0 ties with 0.0
as it does in the JAX package's sort.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _as_x32, _is_integer, _value_check_possible


def _check_retrieval_functional_inputs(
    preds: Tensor,
    target: Tensor,
    allow_non_binary_target: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Validate and flatten one query's ``(preds, target)``: float32 scores and
    the targets as the JAX package sees them (64-bit integers by their low
    32 bits, booleans kept)."""
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    if preds.shape != target.shape or preds.numel() == 0:
        raise ValueError("`preds` and `target` must be non-empty and of the same shape")
    if not preds.is_floating_point():
        raise ValueError("`preds` must be a tensor of floats")
    if not (_is_integer(target) or target.dtype == torch.bool):
        raise ValueError("`target` must be a tensor of booleans or integers")
    target = _as_x32(target)
    if (
        not allow_non_binary_target
        and _value_check_possible(target)
        and bool(torch.any((target > 1) | (target < 0)))
    ):
        raise ValueError("`target` must contain `binary` values")
    return preds.reshape(-1).to(torch.float32), target.reshape(-1)


def _validate_k(k: Optional[int]) -> None:
    if k is not None and not (isinstance(k, int) and k > 0):
        raise ValueError("`k` has to be a positive integer or None")


def _target_by_pred_rank(preds: Tensor, target: Tensor) -> Tensor:
    """Target values reordered by descending score, ties in input order."""
    return target[torch.argsort(-preds, stable=True)]
