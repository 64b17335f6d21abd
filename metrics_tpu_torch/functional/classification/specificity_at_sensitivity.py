"""Specificity-at-sensitivity functionals (port of
``metrics_tpu/functional/classification/specificity_at_sensitivity.py``).

From the ROC curve: among the points with sensitivity (TPR) at least
``min_sensitivity``, the highest specificity (1 - FPR) and its threshold
(1e6 when no point qualifies).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _exact_mode_filter,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from metrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)


def _convert_fpr_to_specificity(fpr: Tensor) -> Tensor:
    return 1 - fpr


def _specificity_at_sensitivity(
    specificity: Tensor, sensitivity: Tensor, thresholds: Tensor, min_sensitivity: float
) -> Tuple[Tensor, Tensor]:
    """Masked maximum over the ROC points with sensitivity >= ``min_sensitivity``."""
    thresholds = thresholds.to(torch.float32)
    n = min(specificity.shape[0], sensitivity.shape[0], thresholds.shape[0])
    qualify = sensitivity[:n] >= min_sensitivity
    masked_spec = torch.where(qualify, specificity[:n], -torch.inf)
    best = torch.argmax(masked_spec)
    any_qualify = torch.any(qualify)
    max_spec = torch.where(any_qualify, masked_spec[best], 0.0)
    max_spec = torch.where(torch.isfinite(max_spec), max_spec, 0.0)
    best_threshold = torch.where(any_qualify, thresholds[best], 1e6)
    return max_spec, best_threshold


def _check_min_sensitivity(min_sensitivity: float) -> None:
    if not isinstance(min_sensitivity, float) or not (0 <= min_sensitivity <= 1):
        raise ValueError(
            f"Expected argument `min_sensitivity` to be an float in the [0,1] range, but got {min_sensitivity}"
        )


def _binary_specificity_at_sensitivity_arg_validation(
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
    _check_min_sensitivity(min_sensitivity)


def _binary_specificity_at_sensitivity_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    thresholds: Optional[Tensor],
    min_sensitivity: float,
    pos_label: int = 1,
) -> Tuple[Tensor, Tensor]:
    fpr, sensitivity, thresholds = _binary_roc_compute(state, thresholds, pos_label)
    return _specificity_at_sensitivity(_convert_fpr_to_specificity(fpr), sensitivity, thresholds, min_sensitivity)


def binary_specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    if validate_args:
        _binary_specificity_at_sensitivity_arg_validation(min_sensitivity, thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds, mask = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    if thresholds is None and ignore_index is not None:
        preds, target = _exact_mode_filter(preds, target, thresholds, ignore_index, mask)
        mask = None
    state = _binary_precision_recall_curve_update(preds, target, thresholds, mask)
    return _binary_specificity_at_sensitivity_compute(state, thresholds, min_sensitivity)


def _multiclass_specificity_at_sensitivity_arg_validation(
    num_classes: int,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
    _check_min_sensitivity(min_sensitivity)


def _per_class(fpr, sensitivity, thresholds, min_sensitivity: float) -> Tuple[Tensor, Tensor]:
    """Per-class selection over a binned ``(C, T)`` curve or exact per-class lists."""
    if isinstance(fpr, Tensor) and fpr.ndim == 2:
        curves = [(f, s, thresholds) for f, s in zip(fpr, sensitivity)]
    else:
        curves = list(zip(fpr, sensitivity, thresholds))
    res = [_specificity_at_sensitivity(_convert_fpr_to_specificity(f), s, t, min_sensitivity) for f, s, t in curves]
    return torch.stack([r[0] for r in res]), torch.stack([r[1] for r in res])


def _multiclass_specificity_at_sensitivity_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_classes: int,
    thresholds: Optional[Tensor],
    min_sensitivity: float,
) -> Tuple[Tensor, Tensor]:
    fpr, sensitivity, thresholds = _multiclass_roc_compute(state, num_classes, thresholds)
    return _per_class(fpr, sensitivity, thresholds, min_sensitivity)


def multiclass_specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    if validate_args:
        _multiclass_specificity_at_sensitivity_arg_validation(num_classes, min_sensitivity, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds, mask = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    if thresholds is None and ignore_index is not None:
        preds, target = _exact_mode_filter(preds, target, thresholds, ignore_index, mask)
        mask = None
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, mask)
    return _multiclass_specificity_at_sensitivity_compute(state, num_classes, thresholds, min_sensitivity)


def _multilabel_specificity_at_sensitivity_arg_validation(
    num_labels: int,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
    _check_min_sensitivity(min_sensitivity)


def _multilabel_specificity_at_sensitivity_compute(
    state,
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int],
    min_sensitivity: float,
) -> Tuple[Tensor, Tensor]:
    fpr, sensitivity, thresholds = _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)
    return _per_class(fpr, sensitivity, thresholds, min_sensitivity)


def multilabel_specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    if validate_args:
        _multilabel_specificity_at_sensitivity_arg_validation(num_labels, min_sensitivity, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds, mask = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, mask)
    return _multilabel_specificity_at_sensitivity_compute(state, num_labels, thresholds, ignore_index, min_sensitivity)
