"""PESQ module metric (port of ``metrics_tpu/audio/pesq.py``): the host
backend's scores summed in float32 over an int32 total; constructing it
without the optional ``pesq`` package raises ``ModuleNotFoundError``."""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.functional.audio.pesq import perceptual_evaluation_speech_quality
from metrics_tpu_torch.metric import Metric, zero_state
from metrics_tpu_torch.utils.imports import _PESQ_AVAILABLE


class PerceptualEvaluationSpeechQuality(Metric):
    """Mean PESQ over samples (needs the optional ``pesq`` package)."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, fs: int, mode: str, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not _PESQ_AVAILABLE:
            raise ModuleNotFoundError(
                "PerceptualEvaluationSpeechQuality metric requires that `pesq` is installed. Either install as"
                " `pip install torchmetrics[audio]` or `pip install pesq`."
            )
        if fs not in (8000, 16000):
            raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
        self.fs = fs
        if mode not in ("wb", "nb"):
            raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
        self.mode = mode
        self.add_state("sum_pesq", zero_state((), device=self.device), dist_reduce_fx="sum")
        self.add_state("total", zero_state((), torch.int32, self.device), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        pesq_batch = perceptual_evaluation_speech_quality(preds, target, self.fs, self.mode).reshape(-1)
        self.sum_pesq = self.sum_pesq + torch.sum(pesq_batch).to(self.device)
        self.total = self.total + pesq_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_pesq / self.total
