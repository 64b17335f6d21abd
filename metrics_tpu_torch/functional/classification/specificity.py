"""Specificity functionals, multiclass part
(port of ``metrics_tpu/functional/classification/specificity.py``)."""

from __future__ import annotations

from typing import Optional

from torch import Tensor

from metrics_tpu_torch.functional.classification._pipeline import multiclass_pipeline
from metrics_tpu_torch.utils.compute import _adjust_weights_safe_divide, _safe_divide


def _specificity_reduce(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    multidim_average: str = "global",
) -> Tensor:
    """Specificity ``tn / (tn + fp)`` from per-class counts (the multilabel
    flag of the JAX reduce comes with that task)."""
    if average == "binary":
        return _safe_divide(tn, tn + fp)
    if average == "micro":
        dim = 0 if multidim_average == "global" else 1
        tn = tn.sum(dim=dim)
        fp = fp.sum(dim=dim)
        return _safe_divide(tn, tn + fp)
    specificity_score = _safe_divide(tn, tn + fp)
    return _adjust_weights_safe_divide(specificity_score, average, tp, fn)


def multiclass_specificity(
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
    return _specificity_reduce(tp, fp, tn, fn, average=average, multidim_average=multidim_average)
