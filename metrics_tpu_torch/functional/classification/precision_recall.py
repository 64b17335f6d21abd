"""Precision / recall functionals, multiclass part
(port of ``metrics_tpu/functional/classification/precision_recall.py``)."""

from __future__ import annotations

from typing import Optional

from torch import Tensor

from metrics_tpu_torch.functional.classification._pipeline import multiclass_pipeline
from metrics_tpu_torch.utils.compute import _adjust_weights_safe_divide, _safe_divide


def _precision_recall_reduce(
    stat: str,
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    multidim_average: str = "global",
) -> Tensor:
    """Precision ``tp / (tp + fp)`` or recall ``tp / (tp + fn)`` from per-class
    counts (the multilabel flag of the JAX reduce comes with that task)."""
    different_stat = fp if stat == "precision" else fn
    if average == "binary":
        return _safe_divide(tp, tp + different_stat)
    if average == "micro":
        dim = 0 if multidim_average == "global" else 1
        tp = tp.sum(dim=dim)
        different_stat = different_stat.sum(dim=dim)
        return _safe_divide(tp, tp + different_stat)
    score = _safe_divide(tp, tp + different_stat)
    return _adjust_weights_safe_divide(score, average, tp, fn)


def multiclass_precision(
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
    return _precision_recall_reduce("precision", tp, fp, tn, fn, average=average, multidim_average=multidim_average)


def multiclass_recall(
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
    return _precision_recall_reduce("recall", tp, fp, tn, fn, average=average, multidim_average=multidim_average)
