"""Precision / recall module metrics, multiclass part
(port of ``metrics_tpu/classification/precision_recall.py``)."""

from __future__ import annotations

from torch import Tensor

from metrics_tpu_torch.classification.stat_scores import MulticlassStatScores
from metrics_tpu_torch.functional.classification.precision_recall import _precision_recall_reduce


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
