"""Top-label calibration error (ECE, RMSCE, MCE) functionals: binary and
multiclass, and the ``calibration_error`` task façade (port of
``metrics_tpu/functional/classification/calibration_error.py``).

The confidences fall into ``n_bins`` bins with edges ``jnp.linspace(0, 1,
n_bins + 1)`` bit for bit (``torch.linspace`` differs in the last bit at some
edges, and a confidence on an edge would change bin), left-open: bin
``searchsorted(edges, c, side="left") - 1``, clipped into ``[0, n_bins - 1]``.
The per-bin sums are a one-hot matrix product, as the JAX package computes
them (no kernel: plain torch code). Float64 input computes in float32, as the
JAX package sees it with x64 off; float16 in float16.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.precision_recall_curve import _linspace01
from metrics_tpu_torch.functional.classification.stat_scores import (
    _ignore_mask,
    _label32,
    _sigmoid_if_logits,
    _softmax_if_logits,
)
from metrics_tpu_torch.utils.checks import _as_x32, _check_same_shape
from metrics_tpu_torch.utils.compute import _safe_divide
from metrics_tpu_torch.utils.data import _one_hot


def _ce_bucketize(
    confidences: Tensor, accuracies: Tensor, n_bins: int, weights: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-bin (accuracy sum, confidence sum, count), weighted, in the confidences' dtype."""
    bounds = _linspace01(n_bins + 1, confidences.device, confidences.dtype)
    idx = torch.clamp(torch.searchsorted(bounds, confidences, right=False) - 1, 0, n_bins - 1)
    w = weights if weights is not None else torch.ones_like(confidences)
    onehot = _one_hot(idx, n_bins, confidences.dtype) * w[:, None]  # (N, B)
    count_bin = torch.sum(onehot, dim=0)
    conf_bin = confidences @ onehot
    acc_bin = accuracies.to(confidences.dtype) @ onehot
    return acc_bin, conf_bin, count_bin


def _ce_compute_from_bins(acc_bin: Tensor, conf_bin: Tensor, count_bin: Tensor, norm: str = "l1") -> Tensor:
    """Calibration error from the per-bin sums."""
    mean_acc = _safe_divide(acc_bin, count_bin)
    mean_conf = _safe_divide(conf_bin, count_bin)
    prop_bin = _safe_divide(count_bin, torch.sum(count_bin))
    if norm == "l1":
        return torch.sum(torch.abs(mean_acc - mean_conf) * prop_bin)
    if norm == "max":
        return torch.max(torch.abs(mean_acc - mean_conf))
    if norm == "l2":
        ce = torch.sum(torch.square(mean_acc - mean_conf) * prop_bin)
        return torch.where(ce > 0, torch.sqrt(torch.clamp(ce, min=0.0)), 0.0)
    raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")


def _ce_compute(confidences: Tensor, accuracies: Tensor, n_bins: int, norm: str = "l1",
                weights: Optional[Tensor] = None) -> Tensor:
    acc_bin, conf_bin, count_bin = _ce_bucketize(confidences, accuracies, n_bins, weights)
    return _ce_compute_from_bins(acc_bin, conf_bin, count_bin, norm)


def _binary_calibration_error_arg_validation(n_bins: int, norm: str = "l1", ignore_index: Optional[int] = None) -> None:
    if not isinstance(n_bins, int) or n_bins < 1:
        raise ValueError(f"Expected argument `n_bins` to be an integer larger than 0, but got {n_bins}")
    if norm not in ("l1", "l2", "max"):
        raise ValueError(f"Expected argument `norm` to be one of ('l1', 'l2', 'max'), but got {norm}.")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _not_float_error(preds: Tensor) -> ValueError:
    name = str(_as_x32(preds).dtype).replace("torch.", "")  # as the JAX package names it (int64 is int32 there)
    return ValueError(f"Expected argument `preds` to be floating tensor with probabilities/logits but got tensor with dtype {name}")


def _binary_calibration_error_tensor_validation(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None
                                                ) -> None:
    _check_same_shape(preds, target)
    if not preds.is_floating_point():
        raise _not_float_error(preds)


def _flat_scores(preds: Tensor, target: Tensor, ignore_index: Optional[int], dtype: Optional[torch.dtype],
                 num_classes: Optional[int] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """Scores as the JAX package sees them (float64 as float32), flat: ``(M,)``
    binary scores or, given ``num_classes``, the ``(M, C)`` rows of ``(N, C,
    ...)`` multiclass scores, cast to ``dtype`` unless it is None; the labels
    by their low 32 bits with the ignored ones zeroed; and the keep mask."""
    preds = _as_x32(preds)
    preds = preds.reshape(-1) if num_classes is None else torch.movedim(preds, 1, -1).reshape(-1, num_classes)
    if dtype is not None:
        preds = preds.to(dtype)
    target = _label32(target).reshape(-1)
    keep = _ignore_mask(target, ignore_index)
    return preds, torch.where(keep, target, 0), keep


def _binary_calibration_format(preds: Tensor, target: Tensor, ignore_index: Optional[int], dtype: Optional[torch.dtype]
                               ) -> Tuple[Tensor, Tensor, Tensor]:
    """Flat confidences (through a sigmoid if they are logits), accuracies and
    the keep weights."""
    preds, target, keep = _flat_scores(preds, target, ignore_index, dtype)
    preds = _sigmoid_if_logits(preds)
    return preds, target.to(preds.dtype), keep.to(preds.dtype)


def binary_calibration_error(
    preds: Tensor,
    target: Tensor,
    n_bins: int = 15,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Top-label calibration error of binary scores."""
    if validate_args:
        _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)
        _binary_calibration_error_tensor_validation(preds, target, ignore_index)
    confidences, accuracies, weights = _binary_calibration_format(preds, target, ignore_index, None)
    return _ce_compute(confidences, accuracies, n_bins, norm, weights=weights)


def _multiclass_calibration_error_arg_validation(
    num_classes: int, n_bins: int, norm: str = "l1", ignore_index: Optional[int] = None
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)


def _multiclass_calibration_error_tensor_validation(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    if preds.ndim != target.ndim + 1:
        raise ValueError("Expected `preds` to have one more dimension than `target`")
    if preds.shape[1] != num_classes:
        raise ValueError(f"Expected `preds.shape[1]={preds.shape[1]}` to equal `num_classes={num_classes}`")
    if not preds.is_floating_point():
        raise _not_float_error(preds)


def _multiclass_calibration_format(preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int],
                                   dtype: Optional[torch.dtype]) -> Tuple[Tensor, Tensor, Tensor]:
    """Top-1 confidences (through a softmax if the rows are logits), 0/1
    accuracies of the top-1 predictions and the keep weights, one a row."""
    preds, target, keep = _flat_scores(preds, target, ignore_index, dtype, num_classes)
    preds = _softmax_if_logits(preds, dim=-1)
    confidences = torch.amax(preds, dim=1)
    accuracies = (torch.argmax(preds, dim=1) == target).to(preds.dtype)
    return confidences, accuracies, keep.to(preds.dtype)


def multiclass_calibration_error(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    n_bins: int = 15,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Top-label calibration error of multiclass scores."""
    if validate_args:
        _multiclass_calibration_error_arg_validation(num_classes, n_bins, norm, ignore_index)
        _multiclass_calibration_error_tensor_validation(preds, target, num_classes, ignore_index)
    confidences, accuracies, weights = _multiclass_calibration_format(preds, target, num_classes, ignore_index, None)
    return _ce_compute(confidences, accuracies, n_bins, norm, weights=weights)


def calibration_error(
    preds: Tensor,
    target: Tensor,
    task: str,
    n_bins: int = 15,
    norm: str = "l1",
    num_classes: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatch façade over the binary and multiclass calibration error.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import calibration_error
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.2, 0.6, 0.2], [0.1, 0.2, 0.7], [0.3, 0.4, 0.3]])
        >>> calibration_error(preds, torch.tensor([0, 1, 2, 1]), task="multiclass", num_classes=3)
        tensor(0.4000)
    """
    task = str(task).lower()
    if task == "binary":
        return binary_calibration_error(preds, target, n_bins, norm, ignore_index, validate_args)
    if task == "multiclass":
        assert isinstance(num_classes, int)
        return multiclass_calibration_error(preds, target, num_classes, n_bins, norm, ignore_index, validate_args)
    raise ValueError(f"Expected argument `task` to either be 'binary' or 'multiclass' but got {task}")
