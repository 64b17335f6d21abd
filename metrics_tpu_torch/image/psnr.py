"""PSNR module metric (port of ``metrics_tpu/image/psnr.py``): float32 sum
states when ``dim`` is None, list states otherwise, and the running target
extremes when ``data_range`` is None."""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.helper import _as_image
from metrics_tpu_torch.functional.image.psnr import _psnr_compute, _psnr_update
from metrics_tpu_torch.metric import Metric, zero_state
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.prints import rank_zero_warn


class PeakSignalNoiseRatio(Metric):
    """Peak Signal Noise Ratio.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PeakSignalNoiseRatio
        >>> preds = torch.tensor([[[[0.1, 0.2], [0.3, 0.4]]]])
        >>> target = torch.tensor([[[[0.1, 0.25], [0.3, 0.45]]]])
        >>> metric = PeakSignalNoiseRatio(data_range=1.0, device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 4)
        29.0309
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        data_range: Optional[float] = None,
        base: float = 10.0,
        reduction: Optional[str] = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if dim is None and reduction != "elementwise_mean":
            rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")

        if dim is None:
            self.add_state("sum_squared_error", zero_state((), device=self.device), dist_reduce_fx="sum")
            self.add_state("total", zero_state((), device=self.device), dist_reduce_fx="sum")
        else:
            self.add_state("sum_squared_error", [], dist_reduce_fx="cat")
            self.add_state("total", [], dist_reduce_fx="cat")

        if data_range is None:
            if dim is not None:
                raise ValueError("The `data_range` must be given when `dim` is not None.")
            self.data_range = None
            self.add_state("min_target", zero_state((), device=self.device), dist_reduce_fx="min")
            self.add_state("max_target", zero_state((), device=self.device), dist_reduce_fx="max")
        else:
            self.add_state("data_range", torch.tensor(float(data_range), dtype=torch.float32), dist_reduce_fx="mean")
        self.base = base
        self.reduction = reduction
        self.dim = tuple(dim) if isinstance(dim, (list, tuple)) else dim

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds = _as_image(preds)
        target = _as_image(target)
        sum_squared_error, n_obs = _psnr_update(preds, target, dim=self.dim)
        if self.dim is None:
            if self.data_range is None:
                # data_range unset: taken at compute from the running target extremes
                self.min_target = torch.minimum(torch.min(target), self.min_target)
                self.max_target = torch.maximum(torch.max(target), self.max_target)
            self.sum_squared_error = self.sum_squared_error + sum_squared_error
            self.total = self.total + n_obs
        else:
            self.sum_squared_error.append(sum_squared_error)
            self.total.append(n_obs)

    def compute(self) -> Tensor:
        data_range = self.data_range if self.data_range is not None else (self.max_target - self.min_target)
        if self.dim is None:
            sum_squared_error = self.sum_squared_error
            total = self.total
        else:
            sum_squared_error = dim_zero_cat(self.sum_squared_error)
            total = dim_zero_cat(self.total)
        return _psnr_compute(sum_squared_error, total, data_range, base=self.base, reduction=self.reduction)
