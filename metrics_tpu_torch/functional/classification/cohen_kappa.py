"""Cohen's kappa functionals: binary and multiclass, and the ``cohen_kappa`` task
façade (port of ``metrics_tpu/functional/classification/cohen_kappa.py``).

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
)


def _cohen_kappa_reduce(confmat: Tensor, weights: Optional[str] = None) -> Tensor:
    """Kappa from a (C, C) confusion matrix, optionally linear- or quadratic-weighted."""
    confmat = confmat.to(torch.float32)
    n_classes = confmat.shape[0]
    sum0 = confmat.sum(dim=0, keepdim=True)
    sum1 = confmat.sum(dim=1, keepdim=True)
    # the JAX package's ``sum1 @ sum0`` is an outer product: one multiply an
    # entry. A broadcast multiply rounds each the same, and no TF32 setting of
    # the process can touch it
    expected = sum1 * sum0 / torch.sum(sum0)

    if weights is None:
        w_mat = torch.ones((n_classes, n_classes), dtype=torch.float32, device=confmat.device) - torch.eye(
            n_classes, dtype=torch.float32, device=confmat.device
        )
    elif weights in ("linear", "quadratic"):
        w_mat = torch.arange(n_classes, dtype=torch.float32, device=confmat.device)
        w_mat = torch.abs(w_mat[:, None] - w_mat[None, :])
        if weights == "quadratic":
            w_mat = w_mat**2
    else:
        raise ValueError(f"Received `weights` for which no implementation exists: {weights}")

    k = torch.sum(w_mat * confmat) / torch.sum(w_mat * expected)
    return 1 - k


def binary_cohen_kappa(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    weights: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    confmat = binary_confusion_matrix(preds, target, threshold, ignore_index, normalize=None, validate_args=validate_args)
    return _cohen_kappa_reduce(confmat, weights)


def multiclass_cohen_kappa(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    weights: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    confmat = multiclass_confusion_matrix(
        preds, target, num_classes, ignore_index, normalize=None, validate_args=validate_args
    )
    return _cohen_kappa_reduce(confmat, weights)


def cohen_kappa(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    weights: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatch façade over the binary and multiclass Cohen's kappa.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import cohen_kappa
        >>> cohen_kappa(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]), task="multiclass", num_classes=3)
        tensor(0.6364)
    """
    task = str(task).lower()
    if task == "binary":
        return binary_cohen_kappa(preds, target, threshold, weights, ignore_index, validate_args)
    if task == "multiclass":
        assert isinstance(num_classes, int)
        return multiclass_cohen_kappa(preds, target, num_classes, weights, ignore_index, validate_args)
    raise ValueError(f"Expected argument `task` to either be 'binary' or 'multiclass' but got {task}")
