"""Numerically-safe compute helpers (port of ``metrics_tpu/utils/compute.py:65-92``)."""

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
