"""ERGAS module metric (port of ``metrics_tpu/image/ergas.py``): a float32
score sum and count for the mean and sum reductions, a list of per-image
scores otherwise."""

from __future__ import annotations

from typing import Any, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.ergas import _ergas_compute, _ergas_update
from metrics_tpu_torch.metric import Metric, zero_state
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.distributed import reduce


class ErrorRelativeGlobalDimensionlessSynthesis(Metric):
    """Error Relative Global Dimensionless Synthesis.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.image import ErrorRelativeGlobalDimensionlessSynthesis
        >>> gen = torch.Generator().manual_seed(0)
        >>> preds = torch.rand(2, 3, 16, 16, generator=gen)
        >>> target = preds * 0.75 + torch.rand(2, 3, 16, 16, generator=gen) * 0.25
        >>> metric = ErrorRelativeGlobalDimensionlessSynthesis(ratio=4, device="cpu")
        >>> metric.update(preds, target)
        >>> float(metric.compute()) > 0
        True
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        ratio: Union[int, float] = 4,
        reduction: Optional[str] = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.ratio = ratio
        self.reduction = reduction
        if reduction in ("elementwise_mean", "sum"):
            self.add_state("score_sum", zero_state((), device=self.device), dist_reduce_fx="sum")
            self.add_state("total", zero_state((), device=self.device), dist_reduce_fx="sum")
        else:
            self.add_state("scores", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _ergas_update(preds, target)
        score = _ergas_compute(preds, target, self.ratio, reduction="none")
        if self.reduction in ("elementwise_mean", "sum"):
            self.score_sum = self.score_sum + torch.sum(score)
            self.total = self.total + score.numel()
        else:
            self.scores.append(score)

    def compute(self) -> Tensor:
        if self.reduction == "elementwise_mean":
            return self.score_sum / self.total
        if self.reduction == "sum":
            return self.score_sum
        return reduce(dim_zero_cat(self.scores), self.reduction)
