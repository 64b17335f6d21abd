"""Hamming distance module metrics: binary, multiclass and multilabel, and the
``HammingDistance`` task façade (port of ``metrics_tpu/classification/hamming.py``).
Each is its stat-scores class with a Hamming ``compute``, so it shares compute
groups with accuracy, F1 and the other stat-score metrics of equal states."""

from __future__ import annotations

from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    _task_metric,
)
from metrics_tpu_torch.functional.classification.hamming import _hamming_distance_reduce
from metrics_tpu_torch.metric import Metric


class BinaryHammingDistance(BinaryStatScores):
    """Fraction of disagreeing labels (1 - accuracy for binary).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import BinaryHammingDistance
        >>> metric = BinaryHammingDistance(device="cpu")
        >>> metric.update(torch.tensor([0, 0, 1, 1, 0, 1]), torch.tensor([0, 1, 0, 1, 0, 1]))
        >>> metric.compute()
        tensor(0.3333)
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _hamming_distance_reduce(tp, fp, tn, fn, average="binary", multidim_average=self.multidim_average)


class MulticlassHammingDistance(MulticlassStatScores):
    """Multiclass Hamming distance.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MulticlassHammingDistance
        >>> metric = MulticlassHammingDistance(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]))
        >>> metric.compute()
        tensor(0.1667)
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _hamming_distance_reduce(tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average)


class MultilabelHammingDistance(MultilabelStatScores):
    """Multilabel Hamming distance.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MultilabelHammingDistance
        >>> metric = MultilabelHammingDistance(num_labels=3, device="cpu")
        >>> metric.update(torch.tensor([[1, 0, 1], [0, 1, 0], [1, 1, 0], [0, 0, 1]]),
        ...               torch.tensor([[1, 0, 0], [0, 1, 0], [1, 0, 0], [0, 1, 1]]))
        >>> metric.compute()
        tensor(0.2500)
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _hamming_distance_reduce(
            tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average, multilabel=True
        )


class HammingDistance:
    """Task-dispatch façade: ``__new__`` returns the task's Hamming distance.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import HammingDistance
        >>> metric = HammingDistance(task="multiclass", num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]))
        >>> metric.compute()
        tensor(0.2500)
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
        classes = (BinaryHammingDistance, MulticlassHammingDistance, MultilabelHammingDistance)
        return _task_metric(task, classes, threshold, num_classes, num_labels, average, top_k, kwargs)
