"""Confusion-matrix functionals: binary, multiclass and multilabel, and the
``confusion_matrix`` task façade
(port of ``metrics_tpu/functional/classification/confusion_matrix.py``).

The binary ``[[tn, fp], [fn, tp]]`` and the multilabel ``(C, 2, 2)`` counts are
the masked products of the stat scores, summed in int32. The multiclass count
is the kernel plane's pair count
(:mod:`metrics_tpu_torch.kernels.confmat`): the CUDA kernel on CUDA tensors,
the bincount reference on CPU tensors. Rows are the true class, columns the
predicted class; ignored pairs and out-of-range class
indices (reachable only with ``validate_args=False``) are dropped. Labels count
by their low 32 bits, as the JAX package sees them with x64 off.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.stat_scores import (
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
    _masked_counts,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
    _task_error,
)
from metrics_tpu_torch.kernels.confmat import pair_count
from metrics_tpu_torch.utils.compute import _safe_divide


def _confusion_matrix_reduce(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    """Normalise over true/pred/all; counts stay int32 when ``normalize`` is None/"none"."""
    allowed_normalize = ("true", "pred", "all", "none", None)
    if normalize not in allowed_normalize:
        raise ValueError(f"Argument `normalize` needs to one of the following: {allowed_normalize}")
    if normalize is not None and normalize != "none":
        confmat = confmat.to(torch.float32)
        if normalize == "true":
            confmat = _safe_divide(confmat, confmat.sum(dim=-1, keepdim=True))
        elif normalize == "pred":
            confmat = _safe_divide(confmat, confmat.sum(dim=-2, keepdim=True))
        elif normalize == "all":
            confmat = _safe_divide(confmat, confmat.sum(dim=(-2, -1), keepdim=True))
    return confmat


def _binary_confusion_matrix_arg_validation(
    threshold: float = 0.5, ignore_index: Optional[int] = None, normalize: Optional[str] = None
) -> None:
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")
    allowed_normalize = ("true", "pred", "all", "none", None)
    if normalize not in allowed_normalize:
        raise ValueError(f"Expected argument `normalize` to be one of {allowed_normalize}, but got {normalize}")


def _binary_confusion_matrix_update(preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
    """``[[tn, fp], [fn, tp]]``, int32."""
    tp, fp, tn, fn = _masked_counts(preds, target, mask, None)
    return torch.stack([torch.stack([tn, fp]), torch.stack([fn, tp])])


def binary_confusion_matrix(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    normalize: Optional[str] = None,
    validate_args: bool = True,
) -> Tensor:
    """2 x 2 confusion matrix, rows = true class.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional.classification import binary_confusion_matrix
        >>> binary_confusion_matrix(torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92]), torch.tensor([0, 1, 0, 1, 0, 1]))
        tensor([[2, 1],
                [1, 2]], dtype=torch.int32)
    """
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize)
        _binary_stat_scores_tensor_validation(preds, target, "global", ignore_index)
    preds, target, mask = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    confmat = _binary_confusion_matrix_update(preds, target, mask)
    return _confusion_matrix_reduce(confmat, normalize)


def _multiclass_confusion_matrix_update(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> Tensor:
    """(C, C) int32 counts, rows = true class, by one pair count. The labels
    go to it as they are (the kernel reads int32 and int64), and so does
    ``ignore_index``, which it compares with the target's low 32 bits."""
    return pair_count(target.reshape(-1), preds.reshape(-1), num_classes, num_classes, ignore_index=ignore_index)


def multiclass_confusion_matrix(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
    normalize: Optional[str] = None,
    validate_args: bool = True,
) -> Tensor:
    if validate_args:
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, "global", ignore_index)
    preds, target = _multiclass_stat_scores_format(preds, target, top_k=1)
    confmat = _multiclass_confusion_matrix_update(preds, target, num_classes, ignore_index)
    return _confusion_matrix_reduce(confmat, normalize)


def _multilabel_confusion_matrix_update(preds: Tensor, target: Tensor, mask: Tensor, num_labels: int) -> Tensor:
    """``(C, 2, 2)`` int32 per-label counts, each ``[[tn, fp], [fn, tp]]``."""
    tp, fp, tn, fn = _masked_counts(preds, target, mask, (0, 2))
    return torch.stack([tn, fp, fn, tp], dim=-1).reshape(num_labels, 2, 2)


def multilabel_confusion_matrix(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    normalize: Optional[str] = None,
    validate_args: bool = True,
) -> Tensor:
    if validate_args:
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, "global", ignore_index)
    preds, target, mask = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    confmat = _multilabel_confusion_matrix_update(preds, target, mask, num_labels)
    return _confusion_matrix_reduce(confmat, normalize)


def confusion_matrix(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatch façade over the binary, multiclass and multilabel confusion matrices.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import confusion_matrix
        >>> confusion_matrix(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]), task="multiclass", num_classes=3)
        tensor([[1, 0, 0],
                [0, 1, 1],
                [0, 0, 1]], dtype=torch.int32)
    """
    task = str(task).lower()
    if task == "binary":
        return binary_confusion_matrix(preds, target, threshold, ignore_index, normalize, validate_args)
    if task == "multiclass":
        assert isinstance(num_classes, int)
        return multiclass_confusion_matrix(preds, target, num_classes, ignore_index, normalize, validate_args)
    if task == "multilabel":
        assert isinstance(num_labels, int)
        return multilabel_confusion_matrix(preds, target, num_labels, threshold, ignore_index, normalize, validate_args)
    raise _task_error(task)
