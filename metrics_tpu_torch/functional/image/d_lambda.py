"""Spectral Distortion Index, D_lambda (port of
``metrics_tpu/functional/image/d_lambda.py``): the cross-band UQI matrices
of every (band_k, band_r) pair, all L^2 pairs in one stacked UQI."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.helper import _as_image
from metrics_tpu_torch.functional.image.uqi import _uqi_compute
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.distributed import reduce


def _spectral_distortion_index_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    preds = _as_image(preds)
    target = _as_image(target)
    if preds.dtype != target.dtype:
        target = target.to(preds.dtype)
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {preds.shape}.")
    return preds, target


def _pairwise_band_uqi(x: Tensor) -> Tensor:
    """(L, L) matrix of UQI between every pair of bands of ``x`` (N, L, H, W)."""
    n, length, h, w = x.shape
    k_idx, r_idx = torch.meshgrid(torch.arange(length, device=x.device), torch.arange(length, device=x.device),
                                  indexing="ij")
    a = x[:, k_idx.reshape(-1)].reshape(n * length * length, 1, h, w)
    b = x[:, r_idx.reshape(-1)].reshape(n * length * length, 1, h, w)
    scores = _uqi_compute(a, b, reduction="none")
    scores = scores.reshape(n, length, length, *scores.shape[1:])
    return torch.mean(scores, dim=(0, *range(3, scores.ndim)))


def _spectral_distortion_index_compute(
    preds: Tensor,
    target: Tensor,
    p: int = 1,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    length = preds.shape[1]
    m1 = _pairwise_band_uqi(target)
    m2 = _pairwise_band_uqi(preds)

    diff = torch.pow(torch.abs(m1 - m2), p)
    if length == 1:
        output = torch.pow(diff, 1.0 / p)
    else:
        output = torch.pow(1.0 / (length * (length - 1)) * torch.sum(diff), 1.0 / p)
    return reduce(output, reduction)


def spectral_distortion_index(
    preds: Tensor,
    target: Tensor,
    p: int = 1,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """D_lambda.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import spectral_distortion_index
        >>> gen = torch.Generator().manual_seed(0)
        >>> preds = torch.rand(2, 3, 32, 32, generator=gen)
        >>> target = preds * 0.75 + torch.rand(2, 3, 32, 32, generator=gen) * 0.25
        >>> float(spectral_distortion_index(preds, target)) < 0.05
        True
    """
    if not isinstance(p, int) or p <= 0:
        raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
    preds, target = _spectral_distortion_index_update(preds, target)
    return _spectral_distortion_index_compute(preds, target, p, reduction)
