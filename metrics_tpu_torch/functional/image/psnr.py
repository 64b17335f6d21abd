"""Peak signal-to-noise ratio (port of ``metrics_tpu/functional/image/psnr.py``).

With ``dim=None`` the squared-error sum of float32 input is one ``torch.dot``
of the flat difference, on every device; the JAX package takes a numpy
float32 dot on the CPU (``_host_sq_diff_sum``) and ``jnp.sum`` elsewhere, so
the sums agree to float32 rounding in another order.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.helper import _as_image, _sum
from metrics_tpu_torch.utils.distributed import reduce
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _psnr_compute(
    sum_squared_error: Tensor,
    n_obs: Tensor,
    data_range: Tensor,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    psnr_base_e = 2 * torch.log(data_range) - torch.log(sum_squared_error / n_obs)
    # 10 / jnp.log(base), in float32 as the JAX package computes it
    psnr_vals = psnr_base_e * float(np.float32(10.0) / np.log(np.float32(base)))
    return reduce(psnr_vals, reduction)


def _psnr_update(
    preds: Tensor,
    target: Tensor,
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tuple[Tensor, Tensor]:
    # scalars are filled on the device (torch.full), not copied from the host: no sync an update
    if dim is None:
        n_obs = torch.full((), float(target.numel()), dtype=torch.float32, device=target.device)
        if preds.dtype == torch.float32 and target.dtype == torch.float32:
            d = (target - preds).reshape(-1)
            return torch.dot(d, d), n_obs
        return _sum(torch.square(preds - target)), n_obs

    diff = preds - target
    dim_list = [dim] if isinstance(dim, int) else list(dim)
    if not dim_list:  # jnp.sum over no axis reduces nothing
        return diff * diff, torch.full((), float(target.numel()), dtype=torch.float32, device=target.device)
    sum_squared_error = _sum(diff * diff, dim=dim_list)
    n = 1
    for d in dim_list:
        n *= target.shape[d]
    n_obs = torch.full(sum_squared_error.shape, float(n), dtype=torch.float32, device=target.device)
    return sum_squared_error, n_obs


def peak_signal_noise_ratio(
    preds: Tensor,
    target: Tensor,
    data_range: Optional[float] = None,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tensor:
    """PSNR.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import peak_signal_noise_ratio
        >>> preds = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> peak_signal_noise_ratio(preds, target)
        tensor(2.5527)
    """
    if dim is None and reduction != "elementwise_mean":
        rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
    preds = _as_image(preds)
    target = _as_image(target)
    if data_range is None:
        if dim is not None:
            raise ValueError("The `data_range` must be given when `dim` is not None.")
        data_range = torch.max(target) - torch.min(target)
    else:
        data_range = torch.full((), float(data_range), dtype=torch.float32, device=target.device)
    sum_squared_error, n_obs = _psnr_update(preds, target, dim=dim)
    return _psnr_compute(sum_squared_error, n_obs, data_range, base=base, reduction=reduction)
