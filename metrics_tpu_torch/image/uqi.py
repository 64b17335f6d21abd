"""UQI module metric (port of ``metrics_tpu/image/uqi.py``): a float32
score sum and count for the mean and sum reductions, a list of per-pixel
scores otherwise."""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.uqi import _uqi_compute, _uqi_update
from metrics_tpu_torch.metric import Metric, zero_state
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.distributed import reduce


class UniversalImageQualityIndex(Metric):
    """Universal Image Quality Index.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.image import UniversalImageQualityIndex
        >>> gen = torch.Generator().manual_seed(0)
        >>> preds = torch.rand(2, 3, 16, 16, generator=gen)
        >>> target = preds * 0.75 + torch.rand(2, 3, 16, 16, generator=gen) * 0.25
        >>> metric = UniversalImageQualityIndex(device="cpu")
        >>> metric.update(preds, target)
        >>> 0.8 < float(metric.compute()) < 1.0
        True
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: Optional[str] = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.reduction = reduction
        if reduction in ("elementwise_mean", "sum"):
            self.add_state("score_sum", zero_state((), device=self.device), dist_reduce_fx="sum")
            self.add_state("total", zero_state((), device=self.device), dist_reduce_fx="sum")
        else:
            self.add_state("scores", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _uqi_update(preds, target)
        score = _uqi_compute(preds, target, self.kernel_size, self.sigma, reduction="none")
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
