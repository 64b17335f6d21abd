"""Accuracy functionals, multiclass part
(port of ``metrics_tpu/functional/classification/accuracy.py``)."""

from __future__ import annotations

from typing import Optional

from torch import Tensor

from metrics_tpu_torch.functional.classification._pipeline import multiclass_pipeline
from metrics_tpu_torch.utils.compute import _adjust_weights_safe_divide, _safe_divide


def _accuracy_reduce(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, average: Optional[str], multidim_average: str = "global"
) -> Tensor:
    """Multiclass accuracy from per-class counts (the binary and multilabel
    branches of the JAX reduce come with those tasks)."""
    if average == "micro":
        dim = 0 if multidim_average == "global" else 1
        return _safe_divide(tp.sum(dim=dim), tp.sum(dim=dim) + fn.sum(dim=dim))
    return _adjust_weights_safe_divide(_safe_divide(tp, tp + fn), average, tp, fn)


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
