"""STOI module metric (port of ``metrics_tpu/audio/stoi.py``): float32 sum and int32 total.

The default ``backend="native"`` runs the port's own STOI on the metric's
device; ``backend="pystoi"`` needs the optional ``pystoi`` package and raises
``ModuleNotFoundError`` at construction without it.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.functional.audio.stoi import short_time_objective_intelligibility
from metrics_tpu_torch.metric import Metric, zero_state
from metrics_tpu_torch.utils.imports import _PYSTOI_AVAILABLE


class ShortTimeObjectiveIntelligibility(Metric):
    """Mean STOI over samples.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.audio import ShortTimeObjectiveIntelligibility
        >>> metric = ShortTimeObjectiveIntelligibility(fs=8000, device="cpu")
        >>> gen = torch.Generator().manual_seed(0)
        >>> target = torch.randn(8000, generator=gen)
        >>> preds = target + 0.1 * torch.randn(8000, generator=gen)
        >>> metric.update(preds, target)
        >>> bool(metric.compute() > 0.9)
        True
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, fs: int, extended: bool = False, backend: str = "native", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if backend == "pystoi" and not _PYSTOI_AVAILABLE:
            raise ModuleNotFoundError(
                "ShortTimeObjectiveIntelligibility with backend='pystoi' requires that `pystoi` is installed."
                " Either install as `pip install torchmetrics[audio]` or `pip install pystoi`,"
                " or use backend='native'."
            )
        if backend not in ("native", "pystoi"):
            raise ValueError(f"backend must be 'native' or 'pystoi', got {backend!r}")
        self.fs = fs
        self.extended = extended
        self.backend = backend
        self.add_state("sum_stoi", zero_state((), device=self.device), dist_reduce_fx="sum")
        self.add_state("total", zero_state((), torch.int32, self.device), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        stoi_batch = short_time_objective_intelligibility(
            preds, target, self.fs, self.extended, backend=self.backend
        ).reshape(-1)
        self.sum_stoi = self.sum_stoi + torch.sum(stoi_batch).to(self.device)
        self.total = self.total + stoi_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_stoi / self.total
