"""Accuracy functionals: binary, multiclass and multilabel, and the ``accuracy``
task façade (port of ``metrics_tpu/functional/classification/accuracy.py``)."""

from __future__ import annotations

from typing import Optional

from torch import Tensor

from metrics_tpu_torch.functional.classification._pipeline import (
    binary_pipeline,
    multiclass_pipeline,
    multilabel_pipeline,
)
from metrics_tpu_torch.functional.classification.stat_scores import _task_error
from metrics_tpu_torch.utils.compute import _adjust_weights_safe_divide, _safe_divide


def _accuracy_reduce(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
) -> Tensor:
    """Accuracy from the counts: ``(tp + tn) / all`` for binary and multilabel
    labels, ``tp / (tp + fn)`` per class for multiclass."""
    if average == "binary":
        return _safe_divide(tp + tn, tp + tn + fp + fn)
    if average == "micro":
        dim = 0 if multidim_average == "global" else 1
        tp = tp.sum(dim=dim)
        fn = fn.sum(dim=dim)
        if multilabel:
            fp = fp.sum(dim=dim)
            tn = tn.sum(dim=dim)
            return _safe_divide(tp + tn, tp + tn + fp + fn)
        return _safe_divide(tp, tp + fn)
    score = _safe_divide(tp + tn, tp + tn + fp + fn) if multilabel else _safe_divide(tp, tp + fn)
    return _adjust_weights_safe_divide(score, average, tp, fn)


def binary_accuracy(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    tp, fp, tn, fn = binary_pipeline(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _accuracy_reduce(tp, fp, tn, fn, average="binary", multidim_average=multidim_average)


def multiclass_accuracy(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    tp, fp, tn, fn = multiclass_pipeline(
        preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )
    return _accuracy_reduce(tp, fp, tn, fn, average=average, multidim_average=multidim_average)


def multilabel_accuracy(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    tp, fp, tn, fn = multilabel_pipeline(
        preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )
    return _accuracy_reduce(tp, fp, tn, fn, average=average, multidim_average=multidim_average, multilabel=True)


def accuracy(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
    top_k: int = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatch façade over the binary, multiclass and multilabel accuracy.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import accuracy
        >>> accuracy(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]), task="multiclass", num_classes=3)
        tensor(0.7500)
    """
    task = str(task).lower()
    if task == "binary":
        return binary_accuracy(preds, target, threshold, multidim_average, ignore_index, validate_args)
    if task == "multiclass":
        assert isinstance(num_classes, int)
        assert isinstance(top_k, int)
        return multiclass_accuracy(
            preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
        )
    if task == "multilabel":
        assert isinstance(num_labels, int)
        return multilabel_accuracy(
            preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
        )
    raise _task_error(task)
