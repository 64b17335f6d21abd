"""Spectral Angle Mapper module metric (port of ``metrics_tpu/image/sam.py``): a float32
score sum and count for the mean and sum reductions, a list of per-pixel
scores otherwise."""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.sam import _sam_compute, _sam_update
from metrics_tpu_torch.metric import Metric, zero_state
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.distributed import reduce


class SpectralAngleMapper(Metric):
    """Spectral Angle Mapper.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.image import SpectralAngleMapper
        >>> gen = torch.Generator().manual_seed(0)
        >>> preds = torch.rand(2, 3, 16, 16, generator=gen)
        >>> target = preds * 0.75 + torch.rand(2, 3, 16, 16, generator=gen) * 0.25
        >>> metric = SpectralAngleMapper(device="cpu")
        >>> metric.update(preds, target)
        >>> 0.0 < float(metric.compute()) < 0.5
        True
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        reduction: Optional[str] = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.reduction = reduction
        if reduction in ("elementwise_mean", "sum"):
            self.add_state("score_sum", zero_state((), device=self.device), dist_reduce_fx="sum")
            self.add_state("total", zero_state((), device=self.device), dist_reduce_fx="sum")
        else:
            self.add_state("scores", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _sam_update(preds, target)
        score = _sam_compute(preds, target, reduction="none")
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
