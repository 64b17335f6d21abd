"""Multilabel ranking module metrics: coverage error, label ranking average
precision and label ranking loss (port of ``metrics_tpu/classification/ranking.py``):
float32 ``measure`` and ``total`` summed over updates."""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.ranking import (
    _multilabel_coverage_error_update,
    _multilabel_ranking_arg_validation,
    _multilabel_ranking_average_precision_update,
    _multilabel_ranking_format,
    _multilabel_ranking_loss_update,
    _multilabel_ranking_tensor_validation,
    _ranking_reduce,
)
from metrics_tpu_torch.metric import Metric, zero_state


class _MultilabelRankingMetric(Metric):
    """Shared shell: format the inputs, accumulate (measure, total)."""

    is_differentiable = False
    full_state_update = False

    measure: Tensor
    total: Tensor

    _update_fn: Callable[[Tensor, Tensor], Tuple[Tensor, Tensor]]  # set by subclasses

    def __init__(
        self,
        num_labels: int,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_ranking_arg_validation(num_labels, ignore_index)
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("measure", zero_state((), torch.float32, self.device), dist_reduce_fx="sum")
        self.add_state("total", zero_state((), torch.float32, self.device), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multilabel_ranking_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        preds, target, _ = _multilabel_ranking_format(preds, target, self.num_labels, self.ignore_index)
        measure, total = type(self)._update_fn(preds, target)
        self.measure = self.measure + measure
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _ranking_reduce(self.measure, self.total)


class MultilabelCoverageError(_MultilabelRankingMetric):
    """Multilabel coverage error.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MultilabelCoverageError
        >>> metric = MultilabelCoverageError(num_labels=3, device="cpu")
        >>> metric.update(torch.tensor([[0.9, 0.1, 0.7], [0.2, 0.8, 0.3], [0.6, 0.4, 0.2], [0.1, 0.7, 0.9]]),
        ...               torch.tensor([[1, 0, 1], [0, 1, 0], [1, 0, 0], [0, 1, 1]]))
        >>> metric.compute()
        tensor(1.5000)
    """

    higher_is_better = False
    _update_fn = staticmethod(_multilabel_coverage_error_update)


class MultilabelRankingAveragePrecision(_MultilabelRankingMetric):
    """Label ranking average precision.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MultilabelRankingAveragePrecision
        >>> metric = MultilabelRankingAveragePrecision(num_labels=3, device="cpu")
        >>> metric.update(torch.tensor([[0.9, 0.1, 0.8], [0.3, 0.7, 0.2]]), torch.tensor([[1, 0, 1], [0, 1, 0]]))
        >>> metric.compute()
        tensor(1.)
    """

    higher_is_better = True
    _update_fn = staticmethod(_multilabel_ranking_average_precision_update)


class MultilabelRankingLoss(_MultilabelRankingMetric):
    """Label ranking loss.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MultilabelRankingLoss
        >>> metric = MultilabelRankingLoss(num_labels=3, device="cpu")
        >>> metric.update(torch.tensor([[0.9, 0.1, 0.7], [0.2, 0.8, 0.3], [0.6, 0.4, 0.2], [0.1, 0.7, 0.9]]),
        ...               torch.tensor([[1, 0, 1], [0, 1, 0], [1, 0, 0], [0, 1, 1]]))
        >>> metric.compute()
        tensor(0.)
    """

    higher_is_better = False
    _update_fn = staticmethod(_multilabel_ranking_loss_update)
