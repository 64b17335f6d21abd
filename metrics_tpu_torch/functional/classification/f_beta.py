"""F-beta / F1 functionals: binary, multiclass and multilabel, and the
``fbeta_score`` and ``f1_score`` task façades
(port of ``metrics_tpu/functional/classification/f_beta.py``)."""

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


def _fbeta_reduce(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    beta: float,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
) -> Tensor:
    """F-beta from the counts (``multilabel`` changes nothing here; it is kept
    for the JAX package's signature)."""
    beta2 = beta**2
    if average == "binary":
        return _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp)
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


def binary_fbeta_score(
    preds: Tensor,
    target: Tensor,
    beta: float,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    if validate_args:
        _validate_beta(beta)
    tp, fp, tn, fn = binary_pipeline(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _fbeta_reduce(tp, fp, tn, fn, beta, average="binary", multidim_average=multidim_average)


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


def multilabel_fbeta_score(
    preds: Tensor,
    target: Tensor,
    beta: float,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    if validate_args:
        _validate_beta(beta)
    tp, fp, tn, fn = multilabel_pipeline(
        preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )
    return _fbeta_reduce(tp, fp, tn, fn, beta, average=average, multidim_average=multidim_average, multilabel=True)


def binary_f1_score(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    return binary_fbeta_score(preds, target, 1.0, threshold, multidim_average, ignore_index, validate_args)


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


def multilabel_f1_score(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    return multilabel_fbeta_score(
        preds, target, 1.0, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )


def fbeta_score(
    preds: Tensor,
    target: Tensor,
    task: str,
    beta: float = 1.0,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
    top_k: int = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatch façade over the binary, multiclass and multilabel F-beta.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import fbeta_score
        >>> fbeta_score(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]), task="multiclass", num_classes=3, beta=0.5)
        tensor(0.7500)
    """
    task = str(task).lower()
    if task == "binary":
        return binary_fbeta_score(preds, target, beta, threshold, multidim_average, ignore_index, validate_args)
    if task == "multiclass":
        return multiclass_fbeta_score(
            preds, target, beta, num_classes, average, top_k, multidim_average, ignore_index, validate_args
        )
    if task == "multilabel":
        return multilabel_fbeta_score(
            preds, target, beta, num_labels, threshold, average, multidim_average, ignore_index, validate_args
        )
    raise _task_error(task)


def f1_score(
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
    """Task-dispatch façade over the binary, multiclass and multilabel F1.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import f1_score
        >>> f1_score(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]), task="multiclass", num_classes=3)
        tensor(0.7500)
    """
    return fbeta_score(
        preds, target, task, 1.0, threshold, num_classes, num_labels, average, multidim_average, top_k, ignore_index,
        validate_args,
    )
