"""Universal Image Quality Index (port of ``metrics_tpu/functional/image/uqi.py``):
SSIM's five window statistics with c1 = c2 = 0."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.helper import (
    _as_image,
    _depthwise_conv_separable,
    _gaussian,
    _reflection_pad,
)
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.distributed import reduce


def _uqi_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    preds = _as_image(preds)
    target = _as_image(target)
    if preds.dtype != target.dtype:
        target = target.to(preds.dtype)
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {preds.shape}.")
    return preds, target


def _uqi_compute(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
) -> Tensor:
    if len(kernel_size) != 2 or len(sigma) != 2:
        raise ValueError(
            "Expected `kernel_size` and `sigma` to have the length of two."
            f" Got kernel_size: {len(kernel_size)} and sigma: {len(sigma)}."
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    dtype = preds.dtype if preds.is_floating_point() else torch.float32
    preds = preds.to(dtype)
    target = target.to(dtype)
    factors = [_gaussian(k, s, dtype, preds.device).reshape(-1) for k, s in zip(kernel_size, sigma)]
    pads = [(k - 1) // 2 for k in kernel_size]

    preds_p = _reflection_pad(preds, pads)
    target_p = _reflection_pad(target, pads)

    input_list = torch.cat([preds_p, target_p, preds_p * preds_p, target_p * target_p, preds_p * target_p])
    outputs = _depthwise_conv_separable(input_list, factors)
    b = preds.shape[0]
    mu_pred, mu_target, e_pp, e_tt, e_pt = (outputs[i * b: (i + 1) * b] for i in range(5))

    mu_pred_sq = torch.square(mu_pred)
    mu_target_sq = torch.square(mu_target)
    mu_pred_target = mu_pred * mu_target

    sigma_pred_sq = e_pp - mu_pred_sq
    sigma_target_sq = e_tt - mu_target_sq
    sigma_pred_target = e_pt - mu_pred_target

    upper = 2 * sigma_pred_target
    lower = sigma_pred_sq + sigma_target_sq

    uqi_idx = ((2 * mu_pred_target) * upper) / ((mu_pred_sq + mu_target_sq) * lower)
    sl = tuple(slice(p, d - p) for p, d in zip(pads, uqi_idx.shape[2:]))
    uqi_idx = uqi_idx[(Ellipsis, *sl)]
    return reduce(uqi_idx, reduction)


def universal_image_quality_index(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
) -> Tensor:
    """UQI.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import universal_image_quality_index
        >>> gen = torch.Generator().manual_seed(0)
        >>> preds = torch.rand(2, 3, 32, 32, generator=gen)
        >>> target = preds * 0.75 + torch.rand(2, 3, 32, 32, generator=gen) * 0.25
        >>> round(float(universal_image_quality_index(preds, target)), 2)
        0.92
    """
    preds, target = _uqi_update(preds, target)
    return _uqi_compute(preds, target, kernel_size, sigma, reduction, data_range)
