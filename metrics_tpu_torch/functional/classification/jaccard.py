"""Jaccard index (IoU) functionals: binary, multiclass and multilabel, and the
``jaccard_index`` task façade (port of ``metrics_tpu/functional/classification/jaccard.py``).

Each reduces the int32 confusion matrix of
:mod:`~metrics_tpu_torch.functional.classification.confusion_matrix`; the
multiclass count is the table route of ``csrc/pair_count.cu`` on the card.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    binary_confusion_matrix,
    multiclass_confusion_matrix,
    multilabel_confusion_matrix,
)
from metrics_tpu_torch.functional.classification.stat_scores import _task_error
from metrics_tpu_torch.utils.compute import _safe_divide


def _jaccard_index_reduce(confmat: Tensor, average: Optional[str], ignore_index: Optional[int] = None) -> Tensor:
    """IoU from a (2, 2), (C, C) or (C, 2, 2) confusion matrix, float32.

    ``ignore_index`` is accepted for the JAX package's signature and changes
    nothing: ignored samples are already out of the matrix, and an in-range
    ignored class still adds its 0 score to the macro mean (plain ones
    weights, as the JAX package's reference keeps them).
    """
    allowed_average = ("binary", "micro", "macro", "weighted", "none", None)
    if average not in allowed_average:
        raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")
    confmat = confmat.to(torch.float32)
    if average == "binary":
        return confmat[1, 1] / (confmat[0, 1] + confmat[1, 0] + confmat[1, 1])

    multilabel = confmat.ndim == 3
    if multilabel:
        num = confmat[:, 1, 1]
        denom = confmat[:, 1, 1] + confmat[:, 0, 1] + confmat[:, 1, 0]
    else:
        num = torch.diagonal(confmat)
        denom = confmat.sum(dim=0) + confmat.sum(dim=1) - num

    if average == "micro":
        num = num.sum()
        denom = denom.sum()

    jaccard = _safe_divide(num, denom)

    if average is None or average == "none" or average == "micro":
        return jaccard
    if average == "weighted":
        weights = confmat[:, 1, 1] + confmat[:, 1, 0] if multilabel else confmat.sum(dim=1)
    else:
        weights = torch.ones_like(jaccard)
    # a plain division: an all-ignored stream (zero total weight, weighted) is NaN, not 0
    return torch.sum(jaccard * weights / torch.sum(weights))


def binary_jaccard_index(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    confmat = binary_confusion_matrix(preds, target, threshold, ignore_index, normalize=None, validate_args=validate_args)
    return _jaccard_index_reduce(confmat, average="binary")


def multiclass_jaccard_index(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    confmat = multiclass_confusion_matrix(
        preds, target, num_classes, ignore_index, normalize=None, validate_args=validate_args
    )
    return _jaccard_index_reduce(confmat, average=average, ignore_index=ignore_index)


def multilabel_jaccard_index(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    confmat = multilabel_confusion_matrix(
        preds, target, num_labels, threshold, ignore_index, normalize=None, validate_args=validate_args
    )
    return _jaccard_index_reduce(confmat, average=average)


def jaccard_index(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatch façade over the binary, multiclass and multilabel Jaccard index.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import jaccard_index
        >>> jaccard_index(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]), task="multiclass", num_classes=3)
        tensor(0.6667)
    """
    task = str(task).lower()
    if task == "binary":
        return binary_jaccard_index(preds, target, threshold, ignore_index, validate_args)
    if task == "multiclass":
        assert isinstance(num_classes, int)
        return multiclass_jaccard_index(preds, target, num_classes, average, ignore_index, validate_args)
    if task == "multilabel":
        assert isinstance(num_labels, int)
        return multilabel_jaccard_index(preds, target, num_labels, threshold, average, ignore_index, validate_args)
    raise _task_error(task)
