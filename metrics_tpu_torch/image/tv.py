"""Total variation module metric (port of ``metrics_tpu/image/tv.py``): a
float32 score sum for the mean and sum reductions, a list otherwise, and an
int32 image count."""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.helper import _as_image
from metrics_tpu_torch.functional.image.tv import _total_variation_update
from metrics_tpu_torch.metric import Metric, zero_state
from metrics_tpu_torch.utils.data import dim_zero_cat


class TotalVariation(Metric):
    """Total Variation.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import TotalVariation
        >>> metric = TotalVariation(device="cpu")
        >>> metric.update(torch.tensor([[[[0.1, 0.2], [0.3, 0.4]]]]))
        >>> metric.compute()
        tensor(0.6000)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if reduction is not None and reduction not in ("sum", "mean", "none"):
            raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")
        self.reduction = reduction

        if self.reduction is None or self.reduction == "none":
            self.add_state("score", [], dist_reduce_fx="cat")
        else:
            self.add_state("score", zero_state((), device=self.device), dist_reduce_fx="sum")
        self.add_state("num_elements", zero_state((), dtype=torch.int32, device=self.device), dist_reduce_fx="sum")

    def update(self, img: Tensor) -> None:
        score, num_elements = _total_variation_update(_as_image(img))
        if self.reduction is None or self.reduction == "none":
            self.score.append(score)
        else:
            self.score = self.score + torch.sum(score)
        self.num_elements = self.num_elements + num_elements

    def compute(self) -> Tensor:
        if self.reduction is None or self.reduction == "none":
            return dim_zero_cat(self.score)
        if self.reduction == "mean":
            return self.score / self.num_elements
        return self.score
