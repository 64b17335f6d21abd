"""ROC curve functionals (port of ``metrics_tpu/functional/classification/roc.py``):
the precision-recall curve's states, with another compute."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _binary_clf_curve,
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
from metrics_tpu_torch.utils.checks import _value_check_possible
from metrics_tpu_torch.utils.compute import _safe_divide


def _binary_roc_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    thresholds: Optional[Tensor],
    pos_label: int = 1,
) -> Tuple[Tensor, Tensor, Tensor]:
    if isinstance(state, Tensor) and thresholds is not None:
        tps = state[:, 1, 1]
        fps = state[:, 0, 1]
        fns = state[:, 1, 0]
        tns = state[:, 0, 0]
        tpr = _safe_divide(tps, tps + fns).flip(0)
        fpr = _safe_divide(fps, fps + tns).flip(0)
        return fpr, tpr, thresholds.flip(0)

    preds, target = state
    fps, tps, thres = _binary_clf_curve(preds, target, pos_label=pos_label)
    # an extra threshold so that the curve starts at (0, 0); the marker is a
    # constant 1.0 (probability semantics), not the largest score + 1
    tps = torch.cat([torch.zeros(1, dtype=tps.dtype, device=tps.device), tps])
    fps = torch.cat([torch.zeros(1, dtype=fps.dtype, device=fps.device), fps])
    thres = torch.cat([torch.ones(1, dtype=thres.dtype, device=thres.device), thres])
    fpr = _safe_divide(fps, fps[-1])
    tpr = _safe_divide(tps, tps[-1])
    return fpr, tpr, thres


def binary_roc(
    preds: Tensor,
    target: Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """ROC curve (fpr, tpr, thresholds) for binary tasks.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import binary_roc
        >>> fpr, tpr, thresholds = binary_roc(torch.tensor([0.1, 0.6, 0.8, 0.4]), torch.tensor([0, 1, 1, 0]), thresholds=4)
        >>> tpr
        tensor([0.0000, 0.5000, 1.0000, 1.0000])
    """
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds, mask = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    if thresholds is None and ignore_index is not None:
        preds, target = _exact_mode_filter(preds, target, thresholds, ignore_index, mask)
        mask = None
    state = _binary_precision_recall_curve_update(preds, target, thresholds, mask)
    return _binary_roc_compute(state, thresholds)


def _multiclass_roc_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_classes: int,
    thresholds: Optional[Tensor],
):
    if isinstance(state, Tensor) and thresholds is not None:
        tps = state[:, :, 1, 1]
        fps = state[:, :, 0, 1]
        fns = state[:, :, 1, 0]
        tns = state[:, :, 0, 0]
        tpr = _safe_divide(tps, tps + fns).flip(0).T
        fpr = _safe_divide(fps, fps + tns).flip(0).T
        return fpr, tpr, thresholds.flip(0)

    preds, target = state
    fpr_list, tpr_list, thres_list = [], [], []
    for i in range(num_classes):
        res = _binary_roc_compute((preds[:, i], (target == i).to(torch.int32)), None, pos_label=1)
        fpr_list.append(res[0])
        tpr_list.append(res[1])
        thres_list.append(res[2])
    return fpr_list, tpr_list, thres_list


def multiclass_roc(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds, mask = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    if thresholds is None and ignore_index is not None:
        preds, target = _exact_mode_filter(preds, target, thresholds, ignore_index, mask)
        mask = None
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, mask)
    return _multiclass_roc_compute(state, num_classes, thresholds)


def _multilabel_roc_compute(
    state,
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
):
    if isinstance(state, Tensor) and thresholds is not None:
        return _multiclass_roc_compute(state, num_labels, thresholds)
    preds, target, mask = state
    fpr_list, tpr_list, thres_list = [], [], []
    for i in range(num_labels):
        p, t, m = preds[:, i], target[:, i], mask[:, i]
        if _value_check_possible(m):
            p, t = p[m], t[m]
        res = _binary_roc_compute((p, t), None, pos_label=1)
        fpr_list.append(res[0])
        tpr_list.append(res[1])
        thres_list.append(res[2])
    return fpr_list, tpr_list, thres_list


def multilabel_roc(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds, mask = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, mask)
    return _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)


def roc(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Task-dispatch façade over binary/multiclass/multilabel ROC curves."""
    task = str(task).lower()
    if task == "binary":
        return binary_roc(preds, target, thresholds, ignore_index, validate_args)
    if task == "multiclass":
        assert isinstance(num_classes, int)
        return multiclass_roc(preds, target, num_classes, thresholds, ignore_index, validate_args)
    if task == "multilabel":
        assert isinstance(num_labels, int)
        return multilabel_roc(preds, target, num_labels, thresholds, ignore_index, validate_args)
    raise ValueError(f"Expected argument `task` to either be 'binary', 'multiclass' or 'multilabel' but got {task}")
