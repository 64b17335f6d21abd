"""PermutationInvariantTraining module metric (port of ``metrics_tpu/audio/pit.py``)."""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import Tensor

from metrics_tpu_torch.functional.audio.pit import permutation_invariant_training
from metrics_tpu_torch.metric import BASE_METRIC_KWARGS, Metric, zero_state


class PermutationInvariantTraining(Metric):
    """Mean best-permutation metric over samples.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.audio import PermutationInvariantTraining
        >>> from metrics_tpu_torch.functional.audio import scale_invariant_signal_distortion_ratio
        >>> gen = torch.Generator().manual_seed(0)
        >>> target = torch.randn(3, 2, 100, generator=gen)
        >>> preds = target.flip(1) + 0.05 * torch.randn(3, 2, 100, generator=gen)
        >>> metric = PermutationInvariantTraining(scale_invariant_signal_distortion_ratio, "max", device="cpu")
        >>> metric.update(preds, target)
        >>> bool(metric.compute() > 20)
        True
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, metric_func: Callable, eval_func: str = "max", **kwargs: Any) -> None:
        base_kwargs = {k: kwargs.pop(k) for k in list(kwargs) if k in BASE_METRIC_KWARGS}
        super().__init__(**base_kwargs)
        if eval_func not in ("max", "min"):
            raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
        self.metric_func = metric_func
        self.eval_func = eval_func
        self.kwargs = kwargs  # the rest go to metric_func
        self.add_state("sum_pit_metric", zero_state((), device=self.device), dist_reduce_fx="sum")
        self.add_state("total", zero_state((), torch.int32, self.device), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        pit_metric = permutation_invariant_training(preds, target, self.metric_func, self.eval_func, **self.kwargs)[0]
        self.sum_pit_metric = self.sum_pit_metric + torch.sum(pit_metric).to(self.device)
        self.total = self.total + pit_metric.numel()

    def compute(self) -> Tensor:
        return self.sum_pit_metric / self.total
