"""F-beta / F1 functionals, multiclass part
(port of ``metrics_tpu/functional/classification/f_beta.py``)."""

from __future__ import annotations

from typing import Optional

from torch import Tensor

from metrics_tpu_torch.functional.classification._pipeline import multiclass_pipeline
from metrics_tpu_torch.utils.compute import _adjust_weights_safe_divide, _safe_divide


def _fbeta_reduce(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    beta: float,
    average: Optional[str],
    multidim_average: str = "global",
) -> Tensor:
    """Multiclass F-beta from per-class counts (the binary and multilabel
    branches of the JAX reduce come with those tasks)."""
    beta2 = beta**2
    if average == "micro":
        dim = 0 if multidim_average == "global" else 1
        tp = tp.sum(dim=dim)
        fn = fn.sum(dim=dim)
        fp = fp.sum(dim=dim)
        return _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp)
    score = _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp)
    return _adjust_weights_safe_divide(score, average, tp, fn)


def _validate_beta(beta: float) -> None:
    if not (isinstance(beta, float) and beta > 0):
        raise ValueError(f"Expected argument `beta` to be a float larger than 0, but got {beta}.")


def multiclass_fbeta_score(
    preds: Tensor,
    target: Tensor,
    beta: float,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    if validate_args:
        _validate_beta(beta)
    tp, fp, tn, fn = multiclass_pipeline(
        preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )
    return _fbeta_reduce(tp, fp, tn, fn, beta, average=average, multidim_average=multidim_average)


def multiclass_f1_score(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    return multiclass_fbeta_score(
        preds, target, 1.0, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )
