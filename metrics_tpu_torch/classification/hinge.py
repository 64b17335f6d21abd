"""Hinge loss module metrics: binary and multiclass, and the ``HingeLoss``
task façade (port of ``metrics_tpu/classification/hinge.py``): float32
``measures`` (a scalar, or ``(C,)`` one-vs-all) and ``total`` summed over
updates; scores of any float dtype are cast to float32 first."""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.calibration_error import _flat_scores
from metrics_tpu_torch.functional.classification.hinge import (
    _binary_hinge_format,
    _binary_hinge_loss_arg_validation,
    _binary_hinge_loss_tensor_validation,
    _binary_hinge_loss_update,
    _hinge_loss_compute,
    _multiclass_hinge_loss_arg_validation,
    _multiclass_hinge_loss_tensor_validation,
    _multiclass_hinge_loss_update,
)
from metrics_tpu_torch.metric import Metric, zero_state
from metrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel


class BinaryHingeLoss(Metric):
    """Binary hinge loss.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import BinaryHingeLoss
        >>> metric = BinaryHingeLoss(device="cpu")
        >>> metric.update(torch.tensor([0.9, 0.1, 0.8]), torch.tensor([1, 0, 1]))
        >>> metric.compute()
        tensor(0.4667)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    measures: Tensor
    total: Tensor

    def __init__(
        self,
        squared: bool = False,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_hinge_loss_arg_validation(squared, ignore_index)
        self.squared = squared
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("measures", zero_state((), torch.float32, self.device), dist_reduce_fx="sum")
        self.add_state("total", zero_state((), torch.float32, self.device), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _binary_hinge_loss_tensor_validation(preds, target, self.ignore_index)
        preds, target, mask = _binary_hinge_format(preds, target, self.ignore_index, torch.float32)
        measures, total = _binary_hinge_loss_update(preds, target, self.squared, mask)
        self.measures = self.measures + measures
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _hinge_loss_compute(self.measures, self.total)


class MulticlassHingeLoss(Metric):
    """Multiclass hinge loss.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MulticlassHingeLoss
        >>> metric = MulticlassHingeLoss(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([[0.7, 0.2, 0.1], [0.2, 0.6, 0.2], [0.1, 0.2, 0.7], [0.3, 0.4, 0.3]]),
        ...               torch.tensor([0, 1, 2, 1]))
        >>> metric.compute()
        tensor(0.6250)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    measures: Tensor
    total: Tensor

    def __init__(
        self,
        num_classes: int,
        squared: bool = False,
        multiclass_mode: str = "crammer-singer",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_hinge_loss_arg_validation(num_classes, squared, multiclass_mode, ignore_index)
        self.num_classes = num_classes
        self.squared = squared
        self.multiclass_mode = multiclass_mode
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        shape = () if multiclass_mode == "crammer-singer" else (num_classes,)
        self.add_state("measures", zero_state(shape, torch.float32, self.device), dist_reduce_fx="sum")
        self.add_state("total", zero_state((), torch.float32, self.device), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_hinge_loss_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target, mask = _flat_scores(preds, target, self.ignore_index, torch.float32, self.num_classes)
        measures, total = _multiclass_hinge_loss_update(preds, target, self.squared, self.multiclass_mode, mask)
        self.measures = self.measures + measures
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _hinge_loss_compute(self.measures, self.total)


class HingeLoss:
    """Task-dispatch façade: ``__new__`` returns the task's hinge loss.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import HingeLoss
        >>> metric = HingeLoss(task="multiclass", num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([[0.7, 0.2, 0.1], [0.2, 0.6, 0.2], [0.1, 0.2, 0.7], [0.3, 0.4, 0.3]]),
        ...               torch.tensor([0, 1, 2, 1]))
        >>> metric.compute()
        tensor(0.6250)
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        num_classes: Optional[int] = None,
        squared: bool = False,
        multiclass_mode: str = "crammer-singer",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTaskNoMultilabel.from_str_or_raise(task)
        kwargs.update({"ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoMultilabel.BINARY:
            return BinaryHingeLoss(squared, **kwargs)
        if task == ClassificationTaskNoMultilabel.MULTICLASS:
            assert isinstance(num_classes, int)
            return MulticlassHingeLoss(num_classes, squared, multiclass_mode, **kwargs)
        raise ValueError(f"Not handled value: {task}")
