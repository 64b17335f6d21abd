"""SDR module metrics (port of ``metrics_tpu/audio/sdr.py``): float32 sums and int32 totals."""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.audio.sdr import (
    scale_invariant_signal_distortion_ratio,
    signal_distortion_ratio,
)
from metrics_tpu_torch.metric import Metric, zero_state


class SignalDistortionRatio(Metric):
    """Mean SDR over samples.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.audio import SignalDistortionRatio
        >>> gen = torch.Generator().manual_seed(0)
        >>> target = torch.randn(2, 400, generator=gen)
        >>> preds = target + 0.1 * torch.randn(2, 400, generator=gen)
        >>> metric = SignalDistortionRatio(filter_length=64, device="cpu")
        >>> metric.update(preds, target)
        >>> bool(metric.compute() > 15)
        True
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        use_cg_iter: Optional[int] = None,
        filter_length: int = 512,
        zero_mean: bool = False,
        load_diag: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.use_cg_iter = use_cg_iter
        self.filter_length = filter_length
        self.zero_mean = zero_mean
        self.load_diag = load_diag
        self.add_state("sum_sdr", zero_state((), device=self.device), dist_reduce_fx="sum")
        self.add_state("total", zero_state((), torch.int32, self.device), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sdr_batch = signal_distortion_ratio(
            preds, target, self.use_cg_iter, self.filter_length, self.zero_mean, self.load_diag
        )
        self.sum_sdr = self.sum_sdr + torch.sum(sdr_batch).to(self.device)
        self.total = self.total + sdr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_sdr / self.total


class ScaleInvariantSignalDistortionRatio(Metric):
    """Mean SI-SDR over samples.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ScaleInvariantSignalDistortionRatio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> metric = ScaleInvariantSignalDistortionRatio(device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 3)
        18.403
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean
        self.add_state("sum_si_sdr", zero_state((), device=self.device), dist_reduce_fx="sum")
        self.add_state("total", zero_state((), torch.int32, self.device), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        si_sdr_batch = scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=self.zero_mean)
        self.sum_si_sdr = self.sum_si_sdr + torch.sum(si_sdr_batch).to(self.device)
        self.total = self.total + si_sdr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_si_sdr / self.total
