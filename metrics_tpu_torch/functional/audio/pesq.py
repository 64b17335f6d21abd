"""PESQ (port of ``metrics_tpu/functional/audio/pesq.py``): a host loop over
the optional ``pesq`` package (ITU-T P.862), which raises
``ModuleNotFoundError`` when the package is missing."""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.imports import _PESQ_AVAILABLE


def perceptual_evaluation_speech_quality(
    preds: Tensor,
    target: Tensor,
    fs: int,
    mode: str,
    keep_same_device: bool = False,
) -> Tensor:
    """PESQ score per sample, computed on the host.

    Args:
        preds: estimated signal ``(..., time)``
        target: reference signal ``(..., time)``
        fs: sampling frequency (8000 or 16000)
        mode: ``'wb'`` (wide-band) or ``'nb'`` (narrow-band)
        keep_same_device: return the score on the inputs' device

    Raises:
        ModuleNotFoundError: if the ``pesq`` package is not installed.
    """
    if not _PESQ_AVAILABLE:
        raise ModuleNotFoundError(
            "PESQ metric requires that pesq is installed. Either install as `pip install torchmetrics[audio]`"
            " or `pip install pesq`."
        )
    if fs not in (8000, 16000):
        raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
    if mode not in ("wb", "nb"):
        raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    _check_same_shape(preds, target)

    import pesq as pesq_backend

    preds_np = preds.detach().cpu().numpy().reshape(-1, preds.shape[-1])
    target_np = target.detach().cpu().numpy().reshape(-1, preds.shape[-1])
    pesq_val_np = np.array([pesq_backend.pesq(fs, t, p, mode) for t, p in zip(target_np, preds_np)])
    pesq_val = torch.from_numpy(pesq_val_np.astype(np.float32)).reshape(preds.shape[:-1])
    return pesq_val.to(preds.device) if keep_same_device else pesq_val
