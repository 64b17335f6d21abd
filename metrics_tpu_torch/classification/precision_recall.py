"""Precision / recall module metrics: binary, multiclass and multilabel, and
the ``Precision`` and ``Recall`` task façades
(port of ``metrics_tpu/classification/precision_recall.py``)."""

from __future__ import annotations

from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    _task_metric,
)
from metrics_tpu_torch.functional.classification.precision_recall import _precision_recall_reduce
from metrics_tpu_torch.metric import Metric


class BinaryPrecision(BinaryStatScores):
    """Binary precision ``tp / (tp + fp)``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import BinaryPrecision
        >>> metric = BinaryPrecision(device="cpu")
        >>> metric.update(torch.tensor([0, 0, 1, 1, 0, 1]), torch.tensor([0, 1, 0, 1, 0, 1]))
        >>> metric.compute()
        tensor(0.6667)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(
            "precision", tp, fp, tn, fn, average="binary", multidim_average=self.multidim_average
        )


class MulticlassPrecision(MulticlassStatScores):
    """Multiclass precision, macro-averaged by default.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MulticlassPrecision
        >>> metric = MulticlassPrecision(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([2, 1, 0, 1]), torch.tensor([2, 1, 0, 1]))
        >>> metric.compute()
        tensor(1.)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(
            "precision", tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average
        )


class MultilabelPrecision(MultilabelStatScores):
    """Multilabel precision, macro-averaged by default.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MultilabelPrecision
        >>> metric = MultilabelPrecision(num_labels=3, device="cpu")
        >>> metric.update(torch.tensor([[1, 0, 1], [0, 1, 0], [1, 1, 0], [0, 0, 1]]),
        ...               torch.tensor([[1, 0, 0], [0, 1, 0], [1, 0, 0], [0, 1, 1]]))
        >>> metric.compute()
        tensor(0.6667)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(
            "precision", tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average, multilabel=True
        )


class BinaryRecall(BinaryStatScores):
    """Binary recall ``tp / (tp + fn)``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import BinaryRecall
        >>> metric = BinaryRecall(device="cpu")
        >>> metric.update(torch.tensor([0, 0, 1, 1, 0, 1]), torch.tensor([0, 1, 0, 1, 0, 1]))
        >>> metric.compute()
        tensor(0.6667)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(
            "recall", tp, fp, tn, fn, average="binary", multidim_average=self.multidim_average
        )


class MulticlassRecall(MulticlassStatScores):
    """Multiclass recall, macro-averaged by default.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MulticlassRecall
        >>> metric = MulticlassRecall(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([2, 1, 0, 1]), torch.tensor([2, 1, 0, 1]))
        >>> metric.compute()
        tensor(1.)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(
            "recall", tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average
        )


class MultilabelRecall(MultilabelStatScores):
    """Multilabel recall, macro-averaged by default.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MultilabelRecall
        >>> metric = MultilabelRecall(num_labels=3, device="cpu")
        >>> metric.update(torch.tensor([[1, 0, 1], [0, 1, 0], [1, 1, 0], [0, 0, 1]]),
        ...               torch.tensor([[1, 0, 0], [0, 1, 0], [1, 0, 0], [0, 1, 1]]))
        >>> metric.compute()
        tensor(0.8333)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(
            "recall", tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average, multilabel=True
        )


class Precision:
    """Task-dispatch façade: ``__new__`` returns the task's precision.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import Precision
        >>> metric = Precision(task="multiclass", num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]))
        >>> metric.compute()
        tensor(0.7500)
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: int = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args})
        return _task_metric(task, (BinaryPrecision, MulticlassPrecision, MultilabelPrecision), threshold, num_classes,
                         num_labels, average, top_k, kwargs)


class Recall:
    """Task-dispatch façade: ``__new__`` returns the task's recall.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import Recall
        >>> metric = Recall(task="multiclass", num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]))
        >>> metric.compute()
        tensor(0.7500)
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: int = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args})
        return _task_metric(task, (BinaryRecall, MulticlassRecall, MultilabelRecall), threshold, num_classes,
                         num_labels, average, top_k, kwargs)
