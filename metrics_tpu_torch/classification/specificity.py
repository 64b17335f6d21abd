"""Specificity module metrics: binary, multiclass and multilabel, and the
``Specificity`` task façade (port of ``metrics_tpu/classification/specificity.py``)."""

from __future__ import annotations

from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    _task_metric,
)
from metrics_tpu_torch.functional.classification.specificity import _specificity_reduce
from metrics_tpu_torch.metric import Metric


class BinarySpecificity(BinaryStatScores):
    """Binary specificity ``tn / (tn + fp)``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import BinarySpecificity
        >>> metric = BinarySpecificity(device="cpu")
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
        return _specificity_reduce(tp, fp, tn, fn, average="binary", multidim_average=self.multidim_average)


class MulticlassSpecificity(MulticlassStatScores):
    """Multiclass specificity, macro-averaged by default.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MulticlassSpecificity
        >>> metric = MulticlassSpecificity(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]))
        >>> metric.compute()
        tensor(0.8889)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _specificity_reduce(tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average)


class MultilabelSpecificity(MultilabelStatScores):
    """Multilabel specificity, macro-averaged by default.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MultilabelSpecificity
        >>> metric = MultilabelSpecificity(num_labels=3, device="cpu")
        >>> metric.update(torch.tensor([[1, 0, 1], [0, 1, 0], [1, 1, 0], [0, 0, 1]]),
        ...               torch.tensor([[1, 0, 0], [0, 1, 0], [1, 0, 0], [0, 1, 1]]))
        >>> metric.compute()
        tensor(0.7222)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _specificity_reduce(
            tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average, multilabel=True
        )


class Specificity:
    """Task-dispatch façade: ``__new__`` returns the task's specificity.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import Specificity
        >>> metric = Specificity(task="multiclass", num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]))
        >>> metric.compute()
        tensor(0.8750)
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
        return _task_metric(task, (BinarySpecificity, MulticlassSpecificity, MultilabelSpecificity), threshold,
                            num_classes, num_labels, average, top_k, kwargs)
