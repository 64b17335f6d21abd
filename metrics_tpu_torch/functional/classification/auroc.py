"""AUROC functionals (port of ``metrics_tpu/functional/classification/auroc.py``):
the trapezoidal area under the ROC curve, binary ``max_fpr`` with the McClish
correction, and the multiclass / multilabel averages."""

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
    _exact_target_for_weights,
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
from metrics_tpu_torch.utils.checks import _value_check_possible
from metrics_tpu_torch.utils.compute import _auc_compute_without_check, _safe_divide
from metrics_tpu_torch.utils.data import _bincount
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _reduce_average(res: Tensor, average: Optional[str], weights: Optional[Tensor]) -> Tensor:
    """Per-class scores averaged as ``average`` says, NaN classes left out
    with a warning (shared by AUROC and average precision)."""
    if average is None or average == "none":
        return res
    if _value_check_possible(res) and bool(torch.isnan(res).any()):
        rank_zero_warn(
            "Average precision score for one or more classes was `nan`. Ignoring these classes in average",
            UserWarning,
        )
    idx = ~torch.isnan(res)
    if average == "macro":
        return torch.mean(res[idx])
    if average == "weighted" and weights is not None:
        weights = torch.where(idx, weights, 0.0)
        weighted = res * _safe_divide(weights, torch.sum(weights))
        return torch.sum(weighted[idx])
    raise ValueError("Received an incompatible combinations of inputs to make reduction.")


def _reduce_auroc(
    fpr: Union[Tensor, list],
    tpr: Union[Tensor, list],
    average: Optional[str] = "macro",
    weights: Optional[Tensor] = None,
) -> Tensor:
    if isinstance(fpr, Tensor) and isinstance(tpr, Tensor):
        res = _auc_compute_without_check(fpr, tpr, 1.0, axis=1)
    else:
        res = torch.stack([_auc_compute_without_check(x, y, 1.0) for x, y in zip(fpr, tpr)])
    return _reduce_average(res, average, weights)


def _binary_auroc_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    thresholds: Optional[Tensor],
    max_fpr: Optional[float] = None,
    pos_label: int = 1,
) -> Tensor:
    fpr, tpr, _ = _binary_roc_compute(state, thresholds, pos_label)
    if max_fpr is None or max_fpr == 1:
        return _auc_compute_without_check(fpr, tpr, 1.0)

    # Partial AUC over fpr <= max_fpr: the curve is cut at max_fpr, the cut
    # point's tpr interpolated between its bracketing points, and the area
    # rescaled onto [0.5, 1] (McClish 1989). Indices as the JAX package's
    # gathers take them: stop - 1 = -1 is the last point, stop = len clamps.
    max_area = torch.tensor(max_fpr, dtype=torch.float32, device=fpr.device)
    stop = int(torch.searchsorted(fpr.contiguous(), max_area.reshape(1), right=True))
    lo, hi = stop - 1, min(stop, fpr.shape[0] - 1)
    weight = (max_area - fpr[lo]) / torch.clamp(fpr[hi] - fpr[lo], min=1e-12)
    interp_tpr = tpr[lo] + weight * (tpr[hi] - tpr[lo])
    tpr = torch.cat([tpr[:stop], interp_tpr.reshape(1)])
    fpr = torch.cat([fpr[:stop], max_area.reshape(1)])
    partial_auc = _auc_compute_without_check(fpr, tpr, 1.0)
    min_area = 0.5 * max_area**2  # the area under the chance diagonal up to the cut
    return 0.5 * (1 + (partial_auc - min_area) / (max_area - min_area))


def binary_auroc(
    preds: Tensor,
    target: Tensor,
    max_fpr: Optional[float] = None,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Area under the ROC curve for binary tasks.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import binary_auroc
        >>> binary_auroc(torch.tensor([0.1, 0.6, 0.8, 0.4]), torch.tensor([0, 1, 1, 0]), thresholds=5)
        tensor(1.)
    """
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
        if max_fpr is not None and not (isinstance(max_fpr, float) and 0 < max_fpr <= 1):
            raise ValueError(f"Arguments `max_fpr` should be a float in range (0, 1], but got: {max_fpr}")
    preds, target, thresholds, mask = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    if thresholds is None and ignore_index is not None:
        preds, target = _exact_mode_filter(preds, target, thresholds, ignore_index, mask)
        mask = None
    state = _binary_precision_recall_curve_update(preds, target, thresholds, mask)
    return _binary_auroc_compute(state, thresholds, max_fpr)


def _class_weights(state, num_classes: int) -> Tensor:
    """Positives per class: from the labels of an exact-mode state, or from
    the first threshold's row of a binned one."""
    if isinstance(state, tuple):
        return _bincount(_exact_target_for_weights(state), minlength=num_classes).to(torch.float32)
    return (state[0, :, 1, 0] + state[0, :, 1, 1]).to(torch.float32)


def _label_weights(state) -> Tensor:
    """Positives per label: from an exact-mode ``(preds, target, mask)`` state, or a binned one."""
    if isinstance(state, tuple):
        return torch.sum((state[1] == 1) & state[2], dim=0).to(torch.float32)
    return (state[0, :, 1, 0] + state[0, :, 1, 1]).to(torch.float32)


def _multiclass_auroc_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Optional[Tensor] = None,
) -> Tensor:
    fpr, tpr, _ = _multiclass_roc_compute(state, num_classes, thresholds)
    return _reduce_auroc(fpr, tpr, average, weights=_class_weights(state, num_classes))


def _check_average(average: Optional[str], allowed: tuple) -> None:
    if average not in allowed:
        raise ValueError(f"Expected argument `average` to be one of {allowed} but got {average}")


def multiclass_auroc(
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
    return _multiclass_auroc_compute(state, num_classes, average, thresholds)


def _multilabel_auroc_compute(
    state,
    num_labels: int,
    average: Optional[str],
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
) -> Tensor:
    if average == "micro":
        if isinstance(state, Tensor) and thresholds is not None:
            return _binary_auroc_compute(torch.sum(state, dim=1, dtype=torch.int32), thresholds, max_fpr=None)
        preds, target, mask = state
        preds, target = _exact_mode_filter(preds.reshape(-1), target.reshape(-1), None, 0, mask.reshape(-1))
        return _binary_auroc_compute((preds, target), None, max_fpr=None)

    fpr, tpr, _ = _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)
    return _reduce_auroc(fpr, tpr, average, weights=_label_weights(state))


def multilabel_auroc(
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
    return _multilabel_auroc_compute(state, num_labels, average, thresholds, ignore_index)


def auroc(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Task-dispatch façade over binary/multiclass/multilabel AUROC."""
    task = str(task).lower()
    if task == "binary":
        return binary_auroc(preds, target, max_fpr, thresholds, ignore_index, validate_args)
    if task == "multiclass":
        assert isinstance(num_classes, int)
        return multiclass_auroc(preds, target, num_classes, average, thresholds, ignore_index, validate_args)
    if task == "multilabel":
        assert isinstance(num_labels, int)
        return multilabel_auroc(preds, target, num_labels, average, thresholds, ignore_index, validate_args)
    raise ValueError(f"Expected argument `task` to either be 'binary', 'multiclass' or 'multilabel' but got {task}")
