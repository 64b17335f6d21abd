"""Specificity module metric, multiclass part
(port of ``metrics_tpu/classification/specificity.py``)."""

from __future__ import annotations

from torch import Tensor

from metrics_tpu_torch.classification.stat_scores import MulticlassStatScores
from metrics_tpu_torch.functional.classification.specificity import _specificity_reduce


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
