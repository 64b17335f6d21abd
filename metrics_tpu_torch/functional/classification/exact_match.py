"""Exact match functionals: multiclass and multilabel, and the ``exact_match``
task façade (port of ``metrics_tpu/functional/classification/exact_match.py``).

A sample scores 1 when every position is correct; ignored positions count as
correct. Plain torch code: a comparison and an ``all`` over the positions."""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.stat_scores import (
    _ignore_mask,
    _label32,
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
)
from metrics_tpu_torch.utils.compute import _safe_divide


def _exact_match_reduce(correct: Tensor, total: Tensor, multidim_average: str) -> Tensor:
    if multidim_average == "global":
        return _safe_divide(torch.sum(correct, dtype=torch.int32), total)
    return correct.to(torch.float32)


def _all_correct(preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
    """int32 1 where every kept position of a sample (dim 1) is correct."""
    return torch.all(torch.where(mask, preds == target, True), dim=1).to(torch.int32)


def _multiclass_exact_match_update(preds: Tensor, target: Tensor, ignore_index: Optional[int]) -> Tensor:
    """(N,) all-correct flags of multiclass input, labels compared by their low 32 bits."""
    preds, target = _multiclass_stat_scores_format(preds, target, top_k=1)
    target = _label32(target)
    return _all_correct(_label32(preds), target, _ignore_mask(target, ignore_index))


def _multilabel_exact_match_update(preds: Tensor, target: Tensor, num_labels: int, threshold: float,
                                   ignore_index: Optional[int]) -> Tensor:
    """(N,) all-correct flags of 2-d multilabel input, (N, X) of more dimensions."""
    squeeze_x = preds.ndim == 2
    preds, target, mask = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    correct = _all_correct(preds, target, mask)
    return correct.squeeze(-1) if squeeze_x else correct


def multiclass_exact_match(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, top_k=1, average=None, multidim_average=multidim_average,
                                               ignore_index=ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    correct = _multiclass_exact_match_update(preds, target, ignore_index)
    total = torch.tensor(correct.shape[0], dtype=torch.float32, device=correct.device)
    return _exact_match_reduce(correct, total, multidim_average)


def multilabel_exact_match(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, average=None, multidim_average=multidim_average,
                                               ignore_index=ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    correct = _multilabel_exact_match_update(preds, target, num_labels, threshold, ignore_index)
    total = torch.tensor(correct.numel(), dtype=torch.float32, device=correct.device)
    return _exact_match_reduce(correct, total, multidim_average)


def exact_match(
    preds: Tensor,
    target: Tensor,
    task: str,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatch façade over the multiclass and multilabel exact match.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import exact_match
        >>> exact_match(torch.tensor([[0, 2], [1, 1]]), torch.tensor([[0, 2], [1, 0]]), task="multiclass", num_classes=3)
        tensor(0.5000)
    """
    task = str(task).lower()
    if task == "multiclass":
        assert num_classes is not None
        return multiclass_exact_match(preds, target, num_classes, multidim_average, ignore_index, validate_args)
    if task == "multilabel":
        assert num_labels is not None
        return multilabel_exact_match(preds, target, num_labels, threshold, multidim_average, ignore_index,
                                      validate_args)
    raise ValueError(f"Expected argument `task` to either be 'multiclass' or 'multilabel' but got {task}")
