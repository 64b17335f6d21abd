"""Hinge loss functionals: binary, multiclass (Crammer-Singer and one-vs-all)
and the ``hinge_loss`` task façade (port of
``metrics_tpu/functional/classification/hinge.py``).

``ignore_index`` is a 0/1 sample weight, so no shape depends on the values.
Plain torch code (no kernel). Float64 scores compute in float32, as the JAX
package sees them with x64 off.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.calibration_error import _flat_scores, _not_float_error
from metrics_tpu_torch.functional.classification.stat_scores import _sigmoid_if_logits, _softmax_if_logits
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.compute import _safe_divide
from metrics_tpu_torch.utils.data import _one_hot


def _hinge_loss_compute(measure: Tensor, total: Tensor) -> Tensor:
    return _safe_divide(measure, total)


def _binary_hinge_loss_arg_validation(squared: bool, ignore_index: Optional[int] = None) -> None:
    if not isinstance(squared, bool):
        raise ValueError(f"Expected argument `squared` to be an bool but got {squared}")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_hinge_loss_tensor_validation(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> None:
    _check_same_shape(preds, target)
    if not preds.is_floating_point():
        raise _not_float_error(preds)


def _binary_hinge_loss_update(
    preds: Tensor, target: Tensor, squared: bool, mask: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor]:
    """margin = +preds for positives, -preds for negatives; measure = relu(1 - margin)."""
    margin = torch.where(target.to(torch.bool), preds, -preds)
    measures = torch.clamp(1 - margin, min=0.0)
    if squared:
        measures = torch.square(measures)
    w = mask.to(preds.dtype) if mask is not None else torch.ones_like(preds)
    return torch.sum(measures * w), torch.sum(w)


def _binary_hinge_format(preds: Tensor, target: Tensor, ignore_index: Optional[int], dtype: Optional[torch.dtype]
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """Flat scores (through a sigmoid if they are logits), labels with ignored
    ones zeroed, and the keep mask."""
    preds, target, mask = _flat_scores(preds, target, ignore_index, dtype)
    return _sigmoid_if_logits(preds), target, mask


def binary_hinge_loss(
    preds: Tensor,
    target: Tensor,
    squared: bool = False,
    ignore_index: Optional[int] = None,
    validate_args: bool = False,
) -> Tensor:
    """Mean hinge loss of binary scores."""
    if validate_args:
        _binary_hinge_loss_arg_validation(squared, ignore_index)
        _binary_hinge_loss_tensor_validation(preds, target, ignore_index)
    preds, target, mask = _binary_hinge_format(preds, target, ignore_index, None)
    measures, total = _binary_hinge_loss_update(preds, target, squared, mask)
    return _hinge_loss_compute(measures, total)


def _multiclass_hinge_loss_arg_validation(
    num_classes: int,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    _binary_hinge_loss_arg_validation(squared, ignore_index)
    allowed_mm = ("crammer-singer", "one-vs-all")
    if multiclass_mode not in allowed_mm:
        raise ValueError(f"Expected argument `multiclass_mode` to be one of {allowed_mm}, but got {multiclass_mode}.")


def _multiclass_hinge_loss_tensor_validation(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    if preds.ndim != target.ndim + 1:
        raise ValueError("Expected `preds` to have one more dimension than `target`")
    if preds.shape[1] != num_classes:
        raise ValueError(f"Expected `preds.shape[1]={preds.shape[1]}` to equal `num_classes={num_classes}`")
    if not preds.is_floating_point():
        raise _not_float_error(preds)


def _multiclass_hinge_loss_update(
    preds: Tensor,
    target: Tensor,
    squared: bool,
    multiclass_mode: str = "crammer-singer",
    mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Summed measures (a scalar, or ``(C,)`` one-vs-all) and the kept samples' count."""
    preds = _softmax_if_logits(preds, dim=1)
    onehot = _one_hot(target, preds.shape[1], torch.bool)
    if multiclass_mode == "crammer-singer":
        margin = torch.sum(torch.where(onehot, preds, 0.0), dim=1)
        margin = margin - torch.amax(torch.where(onehot, -torch.inf, preds), dim=1)
        measures = torch.clamp(1 - margin, min=0.0)
        if squared:
            measures = torch.square(measures)
        w = mask.to(preds.dtype) if mask is not None else torch.ones_like(measures)
        return torch.sum(measures * w), torch.sum(w)
    margin = torch.where(onehot, preds, -preds)
    measures = torch.clamp(1 - margin, min=0.0)
    if squared:
        measures = torch.square(measures)
    w = mask.to(preds.dtype) if mask is not None else torch.ones(preds.shape[0], dtype=preds.dtype, device=preds.device)
    return torch.sum(measures * w[:, None], dim=0), torch.sum(w)


def multiclass_hinge_loss(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
    validate_args: bool = False,
) -> Tensor:
    """Mean hinge loss of multiclass scores."""
    if validate_args:
        _multiclass_hinge_loss_arg_validation(num_classes, squared, multiclass_mode, ignore_index)
        _multiclass_hinge_loss_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, mask = _flat_scores(preds, target, ignore_index, None, num_classes)
    measures, total = _multiclass_hinge_loss_update(preds, target, squared, multiclass_mode, mask)
    return _hinge_loss_compute(measures, total)


def hinge_loss(
    preds: Tensor,
    target: Tensor,
    task: str,
    num_classes: Optional[int] = None,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatch façade over the binary and multiclass hinge loss.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import hinge_loss
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.2, 0.6, 0.2], [0.1, 0.2, 0.7], [0.3, 0.4, 0.3]])
        >>> hinge_loss(preds, torch.tensor([0, 1, 2, 1]), task="multiclass", num_classes=3)
        tensor(0.6250)
    """
    task = str(task).lower()
    if task == "binary":
        return binary_hinge_loss(preds, target, squared, ignore_index, validate_args)
    if task == "multiclass":
        assert isinstance(num_classes, int)
        return multiclass_hinge_loss(preds, target, num_classes, squared, multiclass_mode, ignore_index, validate_args)
    raise ValueError(f"Expected argument `task` to either be 'binary' or 'multiclass' but got {task}")
