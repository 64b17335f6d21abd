"""Numerically-safe compute helpers (port of ``metrics_tpu/utils/compute.py:65-113``)."""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import Tensor


def _as_float(x: Union[Tensor, float, int]) -> Tensor:
    x = torch.as_tensor(x)
    return x if x.is_floating_point() else x.to(torch.float32)


def _safe_divide(num: Union[Tensor, float], denom: Union[Tensor, float], zero_division: float = 0.0) -> Tensor:
    """Element-wise division that returns ``zero_division`` where ``denom == 0``.

    Integer operands are cast to float32 first (as the JAX package does with
    x64 off), and the denominator is replaced before dividing, so no NaN or Inf
    is ever produced.
    """
    num = _as_float(num)
    denom = _as_float(denom)
    zero = denom == 0
    res = num / torch.where(zero, torch.ones((), dtype=denom.dtype, device=denom.device), denom)
    return torch.where(zero, torch.tensor(zero_division, dtype=res.dtype, device=res.device), res)


def _adjust_weights_safe_divide(score: Tensor, average: Optional[str], tp: Tensor, fn: Tensor) -> Tensor:
    """Weighted / macro / none averaging of per-class scores.

    Macro weights are plain ones: classes absent from preds AND target
    contribute a 0/0 -> 0 score to the mean rather than being excluded.
    """
    if average is None or average == "none":
        return score
    weights = tp + fn if average == "weighted" else torch.ones_like(score)
    weights = weights.to(torch.float32)
    return torch.sum(_safe_divide(weights, torch.sum(weights, dim=-1, keepdim=True)) * score, dim=-1)


def _auc_compute_without_check(x: Tensor, y: Tensor, direction: float, axis: int = -1) -> Tensor:
    """Trapezoidal area under the curve; ``direction`` flips the sign for descending ``x``."""
    dx = torch.diff(x, dim=axis)
    n = y.shape[axis]
    y_avg = (torch.narrow(y, axis, 1, n - 1) + torch.narrow(y, axis, 0, n - 1)) / 2.0
    return torch.sum(dx * y_avg, dim=axis) * direction


def _auc_compute(x: Tensor, y: Tensor, reorder: bool = False) -> Tensor:
    if reorder:
        order = torch.argsort(x, stable=True)
        x = x[order]
        y = y[order]
    dx = torch.diff(x)
    direction = torch.where(torch.all(dx <= 0), -1.0, 1.0)
    return _auc_compute_without_check(x, y, direction)


def auc(x: Tensor, y: Tensor, reorder: bool = False) -> Tensor:
    """Area under the curve by the trapezoidal rule."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y)
    if x.ndim != 1 or y.ndim != 1:
        raise ValueError(f"Expected 1-d x and y, got {x.ndim}-d and {y.ndim}-d")
    if x.shape[0] != y.shape[0]:
        raise ValueError("x and y must have the same length")
    return _auc_compute(x, y, reorder=reorder)
