"""SNR and SI-SNR (port of ``metrics_tpu/functional/audio/snr.py``)."""

from __future__ import annotations

import torch
from torch import Tensor

from metrics_tpu_torch.functional.audio.sdr import _audio_pair, scale_invariant_signal_distortion_ratio


def signal_noise_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """Signal-to-noise ratio in dB, per sample over the trailing time axis.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(signal_noise_ratio(preds, target)), 3)
        16.18
    """
    preds, target, eps = _audio_pair(preds, target)

    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)

    noise = target - preds
    snr_value = (torch.sum(target**2, dim=-1) + eps) / (torch.sum(noise**2, dim=-1) + eps)
    return 10 * torch.log10(snr_value)


def scale_invariant_signal_noise_ratio(preds: Tensor, target: Tensor) -> Tensor:
    """SI-SNR: SI-SDR with zero-mean normalization.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(scale_invariant_signal_noise_ratio(preds, target)), 3)
        15.092
    """
    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=True)
