"""Matthews correlation coefficient functionals: binary, multiclass and
multilabel, and the ``matthews_corrcoef`` task façade
(port of ``metrics_tpu/functional/classification/matthews_corrcoef.py``).

Each reduces the int32 confusion matrix of
:mod:`~metrics_tpu_torch.functional.classification.confusion_matrix`; the
multiclass count is the table route of ``csrc/pair_count.cu`` on the card.
The multiclass statistic forms ``s**2 - sum(pk * pk)`` in float32, as the
JAX package does; that difference cancels, so the order of the sums moves
its last bits (the tests state the tolerance).
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


def _matthews_corrcoef_reduce(confmat: Tensor) -> Tensor:
    """The generalised R_k statistic over a (2, 2), (C, C) or (C, 2, 2) matrix."""
    if confmat.ndim == 3:  # multilabel: the per-label 2 x 2 matrices summed
        confmat = confmat.sum(dim=0, dtype=torch.int32)

    if tuple(confmat.shape) == (2, 2):
        tn = confmat[0, 0].to(torch.float32)
        fp = confmat[0, 1].to(torch.float32)
        fn = confmat[1, 0].to(torch.float32)
        tp = confmat[1, 1].to(torch.float32)
        numerator = tp * tn - fp * fn
        denom = torch.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        # Python scalars in the ``where``s: no host-to-device copy
        return torch.where(denom == 0, 0.0, numerator / torch.where(denom == 0, 1.0, denom))

    confmat = confmat.to(torch.float32)
    tk = confmat.sum(dim=-1)  # true occurrences per class
    pk = confmat.sum(dim=-2)  # predicted occurrences per class
    c = torch.trace(confmat)
    s = confmat.sum()

    cov_ytyp = c * s - torch.sum(tk * pk)
    cov_ypyp = s**2 - torch.sum(pk * pk)
    cov_ytyt = s**2 - torch.sum(tk * tk)

    denom = cov_ypyp * cov_ytyt
    return torch.where(denom == 0, 0.0, cov_ytyp / torch.sqrt(torch.where(denom == 0, 1.0, denom)))


def binary_matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    confmat = binary_confusion_matrix(preds, target, threshold, ignore_index, normalize=None, validate_args=validate_args)
    return _matthews_corrcoef_reduce(confmat)


def multiclass_matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    confmat = multiclass_confusion_matrix(
        preds, target, num_classes, ignore_index, normalize=None, validate_args=validate_args
    )
    return _matthews_corrcoef_reduce(confmat)


def multilabel_matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    confmat = multilabel_confusion_matrix(
        preds, target, num_labels, threshold, ignore_index, normalize=None, validate_args=validate_args
    )
    return _matthews_corrcoef_reduce(confmat)


def matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatch façade over the binary, multiclass and multilabel Matthews correlation.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import matthews_corrcoef
        >>> matthews_corrcoef(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]), task="multiclass", num_classes=3)
        tensor(0.7000)
    """
    task = str(task).lower()
    if task == "binary":
        return binary_matthews_corrcoef(preds, target, threshold, ignore_index, validate_args)
    if task == "multiclass":
        assert isinstance(num_classes, int)
        return multiclass_matthews_corrcoef(preds, target, num_classes, ignore_index, validate_args)
    if task == "multilabel":
        assert isinstance(num_labels, int)
        return multilabel_matthews_corrcoef(preds, target, num_labels, threshold, ignore_index, validate_args)
    raise _task_error(task)
