"""Accuracy module metrics: binary, multiclass and multilabel, and the
``Accuracy`` task façade (port of ``metrics_tpu/classification/accuracy.py``)."""

from __future__ import annotations

from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    _task_metric,
)
from metrics_tpu_torch.functional.classification.accuracy import _accuracy_reduce
from metrics_tpu_torch.metric import Metric


class BinaryAccuracy(BinaryStatScores):
    """Binary accuracy over tp/fp/tn/fn sum states.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import BinaryAccuracy
        >>> metric = BinaryAccuracy(device="cpu")
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
        return _accuracy_reduce(tp, fp, tn, fn, average="binary", multidim_average=self.multidim_average)


class MulticlassAccuracy(MulticlassStatScores):
    """Multiclass accuracy with micro/macro/weighted/none averaging.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MulticlassAccuracy
        >>> metric = MulticlassAccuracy(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]))
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
        return _accuracy_reduce(tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average)


class MultilabelAccuracy(MultilabelStatScores):
    """Multilabel accuracy, each label thresholded at 0.5 by default.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MultilabelAccuracy
        >>> metric = MultilabelAccuracy(num_labels=3, device="cpu")
        >>> metric.update(torch.tensor([[0.11, 0.58, 0.22], [0.84, 0.73, 0.33]]), torch.tensor([[0, 1, 0], [1, 0, 1]]))
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
        return _accuracy_reduce(
            tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average, multilabel=True
        )


class Accuracy:
    """Task-dispatch façade: ``__new__`` returns the task's accuracy.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import Accuracy
        >>> metric = Accuracy(task="multiclass", num_classes=3, device="cpu")
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
        return _task_metric(task, (BinaryAccuracy, MulticlassAccuracy, MultilabelAccuracy), threshold, num_classes,
                            num_labels, average, top_k, kwargs)
