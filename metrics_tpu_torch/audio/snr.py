"""SNR module metrics (port of ``metrics_tpu/audio/snr.py``): float32 sums and int32 totals."""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.functional.audio.snr import scale_invariant_signal_noise_ratio, signal_noise_ratio
from metrics_tpu_torch.metric import Metric, zero_state


class SignalNoiseRatio(Metric):
    """Mean SNR over samples.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SignalNoiseRatio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> metric = SignalNoiseRatio(device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 3)
        16.18
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean
        self.add_state("sum_snr", zero_state((), device=self.device), dist_reduce_fx="sum")
        self.add_state("total", zero_state((), torch.int32, self.device), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        snr_batch = signal_noise_ratio(preds=preds, target=target, zero_mean=self.zero_mean)
        self.sum_snr = self.sum_snr + torch.sum(snr_batch).to(self.device)
        self.total = self.total + snr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_snr / self.total


class ScaleInvariantSignalNoiseRatio(Metric):
    """Mean SI-SNR over samples.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ScaleInvariantSignalNoiseRatio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> metric = ScaleInvariantSignalNoiseRatio(device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 3)
        15.092
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_si_snr", zero_state((), device=self.device), dist_reduce_fx="sum")
        self.add_state("total", zero_state((), torch.int32, self.device), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        si_snr_batch = scale_invariant_signal_noise_ratio(preds=preds, target=target)
        self.sum_si_snr = self.sum_si_snr + torch.sum(si_snr_batch).to(self.device)
        self.total = self.total + si_snr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_si_snr / self.total
