"""Precision-recall curve module metrics (port of
``metrics_tpu/classification/precision_recall_curve.py``).

Two state regimes: ``thresholds=None`` keeps the scores and labels as list
states ("cat"), computed exactly; ``thresholds`` given keeps one int32
``confmat`` state of fixed shape per threshold ("sum"), whose update is one
launch of the CUDA threshold-count kernel on the GPU.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _adjust_threshold_arg,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _exact_mode_filter,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from metrics_tpu_torch.metric import Metric, zero_state
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.enums import ClassificationTask


class BinaryPrecisionRecallCurve(Metric):
    """Precision-recall pairs at decision thresholds (exact or binned).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import BinaryPrecisionRecallCurve
        >>> metric = BinaryPrecisionRecallCurve(thresholds=None, device="cpu")
        >>> metric.update(torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92]), torch.tensor([0, 1, 0, 1, 0, 1]))
        >>> precision, recall, thresholds = metric.compute()
        >>> thresholds
        tensor([0.2200, 0.3300, 0.7300, 0.8400, 0.9200])
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    preds: List[Tensor]
    target: List[Tensor]
    confmat: Tensor

    def __init__(
        self,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.thresholds = _adjust_threshold_arg(thresholds, self.device)
        if self.thresholds is None:
            self._host_compute = True
            self.add_state("preds", [], dist_reduce_fx="cat")
            self.add_state("target", [], dist_reduce_fx="cat")
        else:
            shape = (len(self.thresholds), 2, 2)
            self.add_state("confmat", zero_state(shape, dtype=torch.int32, device=self.device), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _binary_precision_recall_curve_tensor_validation(preds, target, self.ignore_index)
        preds, target, _, mask = _binary_precision_recall_curve_format(preds, target, self.thresholds, self.ignore_index)
        if self.thresholds is None:
            preds, target = _exact_mode_filter(preds, target, None, self.ignore_index, mask)
            self.preds.append(preds)
            self.target.append(target)
        else:
            self.confmat = self.confmat + _binary_precision_recall_curve_update(preds, target, self.thresholds, mask)

    def _curve_state(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        if self.thresholds is None:
            return dim_zero_cat(self.preds), dim_zero_cat(self.target)
        return self.confmat

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        return _binary_precision_recall_curve_compute(self._curve_state(), self.thresholds)


class MulticlassPrecisionRecallCurve(Metric):
    """One-vs-rest precision-recall curves for multiclass tasks."""

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.thresholds = _adjust_threshold_arg(thresholds, self.device)
        if self.thresholds is None:
            self._host_compute = True
            self.add_state("preds", [], dist_reduce_fx="cat")
            self.add_state("target", [], dist_reduce_fx="cat")
        else:
            shape = (len(self.thresholds), num_classes, 2, 2)
            self.add_state("confmat", zero_state(shape, dtype=torch.int32, device=self.device), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_precision_recall_curve_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target, _, mask = _multiclass_precision_recall_curve_format(
            preds, target, self.num_classes, self.thresholds, self.ignore_index
        )
        if self.thresholds is None:
            preds, target = _exact_mode_filter(preds, target, None, self.ignore_index, mask)
            self.preds.append(preds)
            self.target.append(target)
        else:
            self.confmat = self.confmat + _multiclass_precision_recall_curve_update(
                preds, target, self.num_classes, self.thresholds, mask
            )

    def _curve_state(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        if self.thresholds is None:
            return dim_zero_cat(self.preds), dim_zero_cat(self.target)
        return self.confmat

    def compute(self):
        return _multiclass_precision_recall_curve_compute(self._curve_state(), self.num_classes, self.thresholds)


class MultilabelPrecisionRecallCurve(Metric):
    """Per-label precision-recall curves for multilabel tasks."""

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        num_labels: int,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.thresholds = _adjust_threshold_arg(thresholds, self.device)
        if self.thresholds is None:
            self._host_compute = True
            self.add_state("preds", [], dist_reduce_fx="cat")
            self.add_state("target", [], dist_reduce_fx="cat")
            self.add_state("mask", [], dist_reduce_fx="cat")
        else:
            shape = (len(self.thresholds), num_labels, 2, 2)
            self.add_state("confmat", zero_state(shape, dtype=torch.int32, device=self.device), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multilabel_precision_recall_curve_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        preds, target, _, mask = _multilabel_precision_recall_curve_format(
            preds, target, self.num_labels, self.thresholds, self.ignore_index
        )
        if self.thresholds is None:
            self.preds.append(preds)
            self.target.append(target)
            self.mask.append(mask)
        else:
            self.confmat = self.confmat + _multilabel_precision_recall_curve_update(
                preds, target, self.num_labels, self.thresholds, mask
            )

    def _curve_state(self) -> Union[Tensor, Tuple[Tensor, Tensor, Tensor]]:
        if self.thresholds is None:
            return dim_zero_cat(self.preds), dim_zero_cat(self.target), dim_zero_cat(self.mask)
        return self.confmat

    def compute(self):
        return _multilabel_precision_recall_curve_compute(
            self._curve_state(), self.num_labels, self.thresholds, self.ignore_index
        )


class PrecisionRecallCurve:
    """Task façade: the binary, multiclass or multilabel class for ``task``."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str_or_raise(task)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryPrecisionRecallCurve(**kwargs)
        if task == ClassificationTask.MULTICLASS:
            assert isinstance(num_classes, int)
            return MulticlassPrecisionRecallCurve(num_classes, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            assert isinstance(num_labels, int)
            return MultilabelPrecisionRecallCurve(num_labels, **kwargs)
        raise ValueError(f"Not handled value: {task}")
