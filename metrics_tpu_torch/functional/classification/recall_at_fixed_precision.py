"""Recall-at-fixed-precision functionals (port of
``metrics_tpu/functional/classification/recall_at_fixed_precision.py``).

From the precision-recall curve: the highest recall among the points with
precision at least ``min_precision``, and the threshold reaching it (1e6 when
no point qualifies).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import Tensor

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


def _recall_at_precision(
    precision: Tensor, recall: Tensor, thresholds: Tensor, min_precision: float
) -> Tuple[Tensor, Tensor]:
    """The lexicographic maximum of (recall, precision, threshold) over the
    points with precision >= ``min_precision``, by three masked maxima.

    The curve's final point (precision 1, recall 0) has no threshold and is
    left out. A curve with no positives (all-NaN recall, exact mode) gives
    ``(nan, thresholds[0])``, as the reference's tuple maximum does.
    """
    thresholds = thresholds.to(torch.float32)
    n_t = thresholds.shape[0]
    precision, recall = precision[:n_t], recall[:n_t]
    qualify = precision >= min_precision
    r_best = torch.max(torch.where(qualify, recall, -torch.inf))
    p_mask = qualify & (recall == r_best)
    p_best = torch.max(torch.where(p_mask, precision, -torch.inf))
    t_mask = p_mask & (precision == p_best)
    t_best = torch.max(torch.where(t_mask, thresholds, -torch.inf))
    max_recall = torch.clamp(r_best, min=0.0)  # clamp keeps a NaN, as jnp.maximum does
    max_recall = torch.where(torch.isfinite(max_recall), max_recall, 0.0)
    any_qualify = torch.any(qualify) & (max_recall > 0.0)
    best_threshold = torch.where(any_qualify, t_best, 1e6)
    if n_t:
        nan_curve = torch.any(qualify) & torch.any(torch.isnan(recall))
        max_recall = torch.where(nan_curve, torch.nan, max_recall)
        best_threshold = torch.where(nan_curve, thresholds[0], best_threshold)
    return max_recall, best_threshold


def _check_min_precision(min_precision: float) -> None:
    if not isinstance(min_precision, float) or not (0 <= min_precision <= 1):
        raise ValueError(
            f"Expected argument `min_precision` to be an float in the [0,1] range, but got {min_precision}"
        )


def _binary_recall_at_fixed_precision_arg_validation(
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
    _check_min_precision(min_precision)


def _binary_recall_at_fixed_precision_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    thresholds: Optional[Tensor],
    min_precision: float,
    pos_label: int = 1,
) -> Tuple[Tensor, Tensor]:
    precision, recall, thresholds = _binary_precision_recall_curve_compute(state, thresholds, pos_label)
    return _recall_at_precision(precision, recall, thresholds, min_precision)


def binary_recall_at_fixed_precision(
    preds: Tensor,
    target: Tensor,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    if validate_args:
        _binary_recall_at_fixed_precision_arg_validation(min_precision, thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds, mask = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    if thresholds is None and ignore_index is not None:
        preds, target = _exact_mode_filter(preds, target, thresholds, ignore_index, mask)
        mask = None
    state = _binary_precision_recall_curve_update(preds, target, thresholds, mask)
    return _binary_recall_at_fixed_precision_compute(state, thresholds, min_precision)


def _multiclass_recall_at_fixed_precision_arg_validation(
    num_classes: int,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
    _check_min_precision(min_precision)


def _per_class(precision, recall, thresholds, min_precision: float) -> Tuple[Tensor, Tensor]:
    """Per-class selection over a binned ``(C, T + 1)`` curve or exact per-class lists."""
    if isinstance(precision, Tensor) and precision.ndim == 2:
        curves = [(p, r, thresholds) for p, r in zip(precision, recall)]
    else:
        curves = list(zip(precision, recall, thresholds))
    res = [_recall_at_precision(p, r, t, min_precision) for p, r, t in curves]
    return torch.stack([r[0] for r in res]), torch.stack([r[1] for r in res])


def _multiclass_recall_at_fixed_precision_arg_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_classes: int,
    thresholds: Optional[Tensor],
    min_precision: float,
) -> Tuple[Tensor, Tensor]:
    precision, recall, thresholds = _multiclass_precision_recall_curve_compute(state, num_classes, thresholds)
    return _per_class(precision, recall, thresholds, min_precision)


def multiclass_recall_at_fixed_precision(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    if validate_args:
        _multiclass_recall_at_fixed_precision_arg_validation(num_classes, min_precision, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds, mask = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    if thresholds is None and ignore_index is not None:
        preds, target = _exact_mode_filter(preds, target, thresholds, ignore_index, mask)
        mask = None
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, mask)
    return _multiclass_recall_at_fixed_precision_arg_compute(state, num_classes, thresholds, min_precision)


def _multilabel_recall_at_fixed_precision_arg_validation(
    num_labels: int,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
    _check_min_precision(min_precision)


def _multilabel_recall_at_fixed_precision_arg_compute(
    state,
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int],
    min_precision: float,
) -> Tuple[Tensor, Tensor]:
    precision, recall, thresholds = _multilabel_precision_recall_curve_compute(state, num_labels, thresholds, ignore_index)
    return _per_class(precision, recall, thresholds, min_precision)


def multilabel_recall_at_fixed_precision(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    if validate_args:
        _multilabel_recall_at_fixed_precision_arg_validation(num_labels, min_precision, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds, mask = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, mask)
    return _multilabel_recall_at_fixed_precision_arg_compute(state, num_labels, thresholds, ignore_index, min_precision)
