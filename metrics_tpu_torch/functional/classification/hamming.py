"""Hamming distance functionals: binary, multiclass and multilabel, and the
``hamming_distance`` task façade (port of
``metrics_tpu/functional/classification/hamming.py``).

One minus the accuracy-style score of the stat scores. The multiclass global
update of label predictions is the stat-score route of ``csrc/pair_count.cu``
on the card (one launch an update)."""

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


def _hamming_distance_reduce(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
) -> Tensor:
    if average == "binary":
        return 1 - _safe_divide(tp + tn, tp + tn + fp + fn)
    if average == "micro":
        dim = 0 if multidim_average == "global" else 1
        tp = tp.sum(dim=dim)
        fn = fn.sum(dim=dim)
        if multilabel:
            fp = fp.sum(dim=dim)
            tn = tn.sum(dim=dim)
            return 1 - _safe_divide(tp + tn, tp + tn + fp + fn)
        return 1 - _safe_divide(tp, tp + fn)
    score = 1 - _safe_divide(tp + tn, tp + tn + fp + fn) if multilabel else 1 - _safe_divide(tp, tp + fn)
    return _adjust_weights_safe_divide(score, average, tp, fn)


def binary_hamming_distance(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    tp, fp, tn, fn = binary_pipeline(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _hamming_distance_reduce(tp, fp, tn, fn, average="binary", multidim_average=multidim_average)


def multiclass_hamming_distance(
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
    return _hamming_distance_reduce(tp, fp, tn, fn, average=average, multidim_average=multidim_average)


def multilabel_hamming_distance(
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
    return _hamming_distance_reduce(
        tp, fp, tn, fn, average=average, multidim_average=multidim_average, multilabel=True
    )


def hamming_distance(
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
    """Task-dispatch façade over the binary, multiclass and multilabel Hamming distance.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import hamming_distance
        >>> hamming_distance(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]), task="multiclass", num_classes=3)
        tensor(0.2500)
    """
    task = str(task).lower()
    if task == "binary":
        return binary_hamming_distance(preds, target, threshold, multidim_average, ignore_index, validate_args)
    if task == "multiclass":
        return multiclass_hamming_distance(
            preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
        )
    if task == "multilabel":
        return multilabel_hamming_distance(
            preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
        )
    raise _task_error(task)
