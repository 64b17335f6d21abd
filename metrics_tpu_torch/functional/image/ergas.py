"""ERGAS (port of ``metrics_tpu/functional/image/ergas.py``): 100 x ratio x the
root mean square over bands of each band's RMSE relative to its mean.

One torch form on every device. The JAX package computes float32 input on the
CPU with a numpy einsum and a gemv (``ergas.py:38-52``), letting a zero-mean
band's inf and NaN through as this form does; the two agree to float32
rounding in another order.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.helper import _as_image, _mean, _sum
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.distributed import reduce


def _ergas_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    preds = _as_image(preds)
    target = _as_image(target)
    if preds.dtype != target.dtype:
        target = target.to(preds.dtype)
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {preds.shape}.")
    return preds, target


def _ergas_compute(
    preds: Tensor,
    target: Tensor,
    ratio: Union[int, float] = 4,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    b, c, h, w = preds.shape
    preds = preds.reshape(b, c, h * w)
    target = target.reshape(b, c, h * w)

    diff = preds - target
    sum_squared_error = _sum(diff * diff, dim=2)
    rmse_per_band = torch.sqrt(sum_squared_error / (h * w))
    mean_target = _mean(target, dim=2)

    ergas_score = 100 * ratio * torch.sqrt(torch.sum(torch.square(rmse_per_band / mean_target), dim=1) / c)
    return reduce(ergas_score, reduction)


def error_relative_global_dimensionless_synthesis(
    preds: Tensor,
    target: Tensor,
    ratio: Union[int, float] = 4,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """ERGAS.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import error_relative_global_dimensionless_synthesis
        >>> gen = torch.Generator().manual_seed(0)
        >>> preds = torch.rand(2, 3, 32, 32, generator=gen)
        >>> target = preds * 0.75 + torch.rand(2, 3, 32, 32, generator=gen) * 0.25
        >>> float(error_relative_global_dimensionless_synthesis(preds, target, ratio=4)) > 0
        True
    """
    preds, target = _ergas_update(preds, target)
    return _ergas_compute(preds, target, ratio, reduction)
