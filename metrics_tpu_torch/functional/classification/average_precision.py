"""Average precision functionals (port of
``metrics_tpu/functional/classification/average_precision.py``):
AP = sum of (R_i - R_{i-1}) * P_i over the precision-recall curve."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.auroc import (
    _check_average,
    _class_weights,
    _label_weights,
    _reduce_average,
)
from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _exact_mode_filter,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)


def _reduce_average_precision(
    precision: Union[Tensor, list],
    recall: Union[Tensor, list],
    average: Optional[str] = "macro",
    weights: Optional[Tensor] = None,
) -> Tensor:
    if isinstance(precision, Tensor) and isinstance(recall, Tensor):
        res = -torch.sum((recall[:, 1:] - recall[:, :-1]) * precision[:, :-1], dim=1)
    else:
        res = torch.stack([-torch.sum((r[1:] - r[:-1]) * p[:-1]) for p, r in zip(precision, recall)])
    return _reduce_average(res, average, weights)


def _binary_average_precision_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    thresholds: Optional[Tensor],
    pos_label: int = 1,
) -> Tensor:
    precision, recall, _ = _binary_precision_recall_curve_compute(state, thresholds, pos_label)
    return -torch.sum((recall[1:] - recall[:-1]) * precision[:-1])


def binary_average_precision(
    preds: Tensor,
    target: Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Average precision for binary tasks.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import binary_average_precision
        >>> binary_average_precision(torch.tensor([0.1, 0.6, 0.8, 0.4]), torch.tensor([0, 1, 1, 0]), thresholds=5)
        tensor(1.)
    """
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds, mask = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    if thresholds is None and ignore_index is not None:
        preds, target = _exact_mode_filter(preds, target, thresholds, ignore_index, mask)
        mask = None
    state = _binary_precision_recall_curve_update(preds, target, thresholds, mask)
    return _binary_average_precision_compute(state, thresholds)


def _multiclass_average_precision_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Optional[Tensor] = None,
) -> Tensor:
    precision, recall, _ = _multiclass_precision_recall_curve_compute(state, num_classes, thresholds)
    return _reduce_average_precision(precision, recall, average, weights=_class_weights(state, num_classes))


def multiclass_average_precision(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
        _check_average(average, ("macro", "weighted", "none", None))
    preds, target, thresholds, mask = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    if thresholds is None and ignore_index is not None:
        preds, target = _exact_mode_filter(preds, target, thresholds, ignore_index, mask)
        mask = None
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, mask)
    return _multiclass_average_precision_compute(state, num_classes, average, thresholds)


def _multilabel_average_precision_compute(
    state,
    num_labels: int,
    average: Optional[str],
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
) -> Tensor:
    if average == "micro":
        if isinstance(state, Tensor) and thresholds is not None:
            return _binary_average_precision_compute(torch.sum(state, dim=1, dtype=torch.int32), thresholds)
        preds, target, mask = state
        preds, target = _exact_mode_filter(preds.reshape(-1), target.reshape(-1), None, 0, mask.reshape(-1))
        return _binary_average_precision_compute((preds, target), None)

    precision, recall, _ = _multilabel_precision_recall_curve_compute(state, num_labels, thresholds, ignore_index)
    return _reduce_average_precision(precision, recall, average, weights=_label_weights(state))


def multilabel_average_precision(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
        _check_average(average, ("micro", "macro", "weighted", "none", None))
    preds, target, thresholds, mask = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, mask)
    return _multilabel_average_precision_compute(state, num_labels, average, thresholds, ignore_index)


def average_precision(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Task-dispatch façade over binary/multiclass/multilabel average precision."""
    task = str(task).lower()
    if task == "binary":
        return binary_average_precision(preds, target, thresholds, ignore_index, validate_args)
    if task == "multiclass":
        assert isinstance(num_classes, int)
        return multiclass_average_precision(preds, target, num_classes, average, thresholds, ignore_index, validate_args)
    if task == "multilabel":
        assert isinstance(num_labels, int)
        return multilabel_average_precision(preds, target, num_labels, average, thresholds, ignore_index, validate_args)
    raise ValueError(f"Expected argument `task` to either be 'binary', 'multiclass' or 'multilabel' but got {task}")
