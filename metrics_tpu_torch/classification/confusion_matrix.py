"""Confusion-matrix module metrics: binary, multiclass and multilabel, and the
``ConfusionMatrix`` task façade (port of ``metrics_tpu/classification/confusion_matrix.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_arg_validation,
    _binary_confusion_matrix_update,
    _confusion_matrix_reduce,
    _multiclass_confusion_matrix_update,
    _multilabel_confusion_matrix_update,
)
from metrics_tpu_torch.functional.classification.stat_scores import (
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
)
from metrics_tpu_torch.metric import Metric, zero_state
from metrics_tpu_torch.utils.enums import ClassificationTask


class BinaryConfusionMatrix(Metric):
    """2 x 2 int32 confusion matrix from thresholded scores or labels, rows = true class.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import BinaryConfusionMatrix
        >>> metric = BinaryConfusionMatrix(device="cpu")
        >>> metric.update(torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92]), torch.tensor([0, 1, 0, 1, 0, 1]))
        >>> metric.compute()
        tensor([[2, 1],
                [1, 2]], dtype=torch.int32)
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        normalize: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize)
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.normalize = normalize
        self.validate_args = validate_args
        self.add_state("confmat", zero_state((2, 2), dtype=torch.int32, device=self.device), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _binary_stat_scores_tensor_validation(preds, target, "global", self.ignore_index)
        preds, target, mask = _binary_stat_scores_format(preds, target, self.threshold, self.ignore_index)
        self.confmat = self.confmat + _binary_confusion_matrix_update(preds, target, mask)

    def compute(self) -> Tensor:
        return _confusion_matrix_reduce(self.confmat, self.normalize)


class MulticlassConfusionMatrix(Metric):
    """(C, C) int32 confusion matrix, rows = true class.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MulticlassConfusionMatrix
        >>> metric = MulticlassConfusionMatrix(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([2, 1, 0, 1]), torch.tensor([2, 1, 0, 1]))
        >>> metric.compute()
        tensor([[1, 0, 0],
                [0, 2, 0],
                [0, 0, 1]], dtype=torch.int32)
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        ignore_index: Optional[int] = None,
        normalize: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.normalize = normalize
        self.validate_args = validate_args
        self.add_state(
            "confmat", zero_state((num_classes, num_classes), dtype=torch.int32, device=self.device), dist_reduce_fx="sum"
        )

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(preds, target, self.num_classes, "global", self.ignore_index)
        preds, target = _multiclass_stat_scores_format(preds, target, top_k=1)
        self.confmat = self.confmat + _multiclass_confusion_matrix_update(
            preds, target, self.num_classes, self.ignore_index
        )

    def compute(self) -> Tensor:
        return _confusion_matrix_reduce(self.confmat, self.normalize)


class MultilabelConfusionMatrix(Metric):
    """(C, 2, 2) int32 per-label confusion matrices.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MultilabelConfusionMatrix
        >>> metric = MultilabelConfusionMatrix(num_labels=3, device="cpu")
        >>> metric.update(torch.tensor([[1, 0, 1], [0, 1, 0], [1, 1, 0], [0, 0, 1]]),
        ...               torch.tensor([[1, 0, 0], [0, 1, 0], [1, 0, 0], [0, 1, 1]]))
        >>> metric.compute()
        tensor([[[2, 0],
                 [0, 2]],
        <BLANKLINE>
                [[1, 1],
                 [1, 1]],
        <BLANKLINE>
                [[2, 1],
                 [0, 1]]], dtype=torch.int32)
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        normalize: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_labels = num_labels
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.normalize = normalize
        self.validate_args = validate_args
        self.add_state(
            "confmat", zero_state((num_labels, 2, 2), dtype=torch.int32, device=self.device), dist_reduce_fx="sum"
        )

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multilabel_stat_scores_tensor_validation(preds, target, self.num_labels, "global", self.ignore_index)
        preds, target, mask = _multilabel_stat_scores_format(preds, target, self.num_labels, self.threshold, self.ignore_index)
        self.confmat = self.confmat + _multilabel_confusion_matrix_update(preds, target, mask, self.num_labels)

    def compute(self) -> Tensor:
        return _confusion_matrix_reduce(self.confmat, self.normalize)


class ConfusionMatrix:
    """Task-dispatch façade: ``__new__`` returns the task's confusion matrix.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import ConfusionMatrix
        >>> metric = ConfusionMatrix(task="multiclass", num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]))
        >>> metric.compute()
        tensor([[1, 0, 0],
                [0, 1, 1],
                [0, 0, 1]], dtype=torch.int32)
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        normalize: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str_or_raise(task)
        kwargs.update({"normalize": normalize, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryConfusionMatrix(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            assert isinstance(num_classes, int)
            return MulticlassConfusionMatrix(num_classes, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            assert isinstance(num_labels, int)
            return MultilabelConfusionMatrix(num_labels, threshold, **kwargs)
        raise ValueError(f"Not handled value: {task}")
