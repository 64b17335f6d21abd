"""Error-sum regression functionals: MAE, MSE, MAPE, SMAPE, WMAPE, MSLE and
LogCosh (port of ``metrics_tpu/functional/regression/basic.py``).

Each is an ``_*_update`` (a sum of errors and a count) and an ``_*_compute``
(the division), the two-sum streaming pattern. The sums are plain torch
reductions in the inputs' dtype (float32 for float32 inputs), as the JAX
package's are jnp reductions; no kernel of the JAX package lies on them.
Float64 inputs are first cast to float32, as ``jnp.asarray`` does with 64-bit
mode off, so every sum and output is float32 (float16 and integer inputs
keep the JAX package's dtypes).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape


def _x32(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Float64 inputs as float32, the JAX package's view with 64-bit mode off."""
    return (preds.to(torch.float32) if preds.dtype == torch.float64 else preds,
            target.to(torch.float32) if target.dtype == torch.float64 else target)


def _as_float(x: Tensor) -> Tensor:
    return x if x.is_floating_point() else x.to(torch.float32)


def _at_least_float32(x: Tensor) -> Tensor:
    """Half-precision inputs accumulate in float32 (float16 overflows at 65504,
    bfloat16 loses whole counts past 256), as in the JAX package."""
    return x.to(torch.float32) if x.is_floating_point() and torch.finfo(x.dtype).bits < 32 else x


def _mean_absolute_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    preds, target = _x32(preds, target)
    return torch.sum(torch.abs(_as_float(preds) - _as_float(target))), target.numel()


def _mean_absolute_error_compute(sum_abs_error: Tensor, num_obs: Tensor) -> Tensor:
    return sum_abs_error / num_obs


def mean_absolute_error(preds: Tensor, target: Tensor) -> Tensor:
    """MAE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import mean_absolute_error
        >>> mean_absolute_error(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        tensor(0.5000)
    """
    sum_abs_error, num_obs = _mean_absolute_error_update(preds, target)
    return _mean_absolute_error_compute(sum_abs_error, num_obs)


def _mean_squared_error_update(preds: Tensor, target: Tensor, num_outputs: int) -> Tuple[Tensor, int]:
    """The sum of squared errors (over rows: ``(num_outputs,)`` for 2-D inputs
    with several outputs) and the number of rows."""
    _check_same_shape(preds, target)
    preds, target = _x32(preds, target)
    if num_outputs == 1:
        preds = preds.reshape(-1)
        target = target.reshape(-1)
    diff = _at_least_float32(preds) - _at_least_float32(target)
    return (diff * diff).sum(dim=0, dtype=diff.dtype), target.shape[0]


def _mean_squared_error_compute(sum_squared_error: Tensor, num_obs: Tensor, squared: bool = True) -> Tensor:
    res = sum_squared_error / num_obs
    return res if squared else torch.sqrt(res)


def mean_squared_error(preds: Tensor, target: Tensor, squared: bool = True, num_outputs: int = 1) -> Tensor:
    """MSE, or RMSE with ``squared=False``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import mean_squared_error
        >>> mean_squared_error(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        tensor(0.3750)
    """
    sum_squared_error, num_obs = _mean_squared_error_update(preds, target, num_outputs)
    return _mean_squared_error_compute(sum_squared_error, num_obs, squared)


def _mean_absolute_percentage_error_update(preds: Tensor, target: Tensor, epsilon: float = 1.17e-06
                                           ) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    preds, target = _x32(preds, target)
    return torch.sum(torch.abs(preds - target) / torch.clamp(torch.abs(target), min=epsilon)), target.numel()


def _mean_absolute_percentage_error_compute(sum_abs_per_error: Tensor, num_obs: Tensor) -> Tensor:
    return sum_abs_per_error / num_obs


def mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """MAPE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import mean_absolute_percentage_error
        >>> mean_absolute_percentage_error(torch.tensor([0.5, 1.2, 2.0, 4.0]), torch.tensor([0.6, 1.0, 2.5, 3.5]))
        tensor(0.1774)
    """
    s, n = _mean_absolute_percentage_error_update(preds, target)
    return _mean_absolute_percentage_error_compute(s, n)


def _symmetric_mean_absolute_percentage_error_update(preds: Tensor, target: Tensor, epsilon: float = 1.17e-06
                                                     ) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    preds, target = _x32(preds, target)
    abs_per_error = torch.abs(preds - target) / torch.clamp(torch.abs(target) + torch.abs(preds), min=epsilon)
    return 2 * torch.sum(abs_per_error), target.numel()


def symmetric_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """SMAPE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import symmetric_mean_absolute_percentage_error
        >>> symmetric_mean_absolute_percentage_error(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        tensor(0.5788)
    """
    s, n = _symmetric_mean_absolute_percentage_error_update(preds, target)
    return s / n


def _weighted_mean_absolute_percentage_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    preds, target = _x32(preds, target)
    return torch.sum(torch.abs((preds - target).reshape(-1))), torch.sum(torch.abs(target.reshape(-1)))


def _weighted_mean_absolute_percentage_error_compute(sum_abs_error: Tensor, sum_scale: Tensor,
                                                     epsilon: float = 1.17e-06) -> Tensor:
    return sum_abs_error / torch.clamp(sum_scale, min=epsilon)


def weighted_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """WMAPE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import weighted_mean_absolute_percentage_error
        >>> weighted_mean_absolute_percentage_error(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        tensor(0.1600)
    """
    s, scale = _weighted_mean_absolute_percentage_error_update(preds, target)
    return _weighted_mean_absolute_percentage_error_compute(s, scale)


def _mean_squared_log_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    preds, target = _x32(preds, target)
    return torch.sum((torch.log1p(preds) - torch.log1p(target)) ** 2), target.numel()


def mean_squared_log_error(preds: Tensor, target: Tensor) -> Tensor:
    """MSLE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import mean_squared_log_error
        >>> mean_squared_log_error(torch.tensor([0.5, 1.2, 2.0, 4.0]), torch.tensor([0.6, 1.0, 2.5, 3.5]))
        tensor(0.0120)
    """
    s, n = _mean_squared_log_error_update(preds, target)
    return s / n


def _unsqueeze_tensors(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    if preds.ndim == 1:
        return preds[:, None], target[:, None]
    return preds, target


def jax_softplus(x: Tensor) -> Tensor:
    """``log(1 + exp(x))`` as the JAX package writes it, ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _log_cosh_error_update(preds: Tensor, target: Tensor, num_outputs: int) -> Tuple[Tensor, int]:
    """The per-output sum of ``log(cosh(preds - target))`` in its stable form
    ``x + softplus(-2x) - log(2)``, and the number of rows."""
    _check_same_shape(preds, target)
    preds, target = _x32(preds, target)
    preds, target = _unsqueeze_tensors(preds, target)
    diff = preds - target
    return torch.sum(diff + jax_softplus(-2.0 * diff) - math.log(2.0), dim=0), preds.shape[0]


def _log_cosh_error_compute(sum_log_cosh_error: Tensor, num_obs: Tensor) -> Tensor:
    return torch.squeeze(sum_log_cosh_error / num_obs)


def log_cosh_error(preds: Tensor, target: Tensor) -> Tensor:
    """LogCosh error.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import log_cosh_error
        >>> log_cosh_error(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        tensor(0.1685)
    """
    s, n = _log_cosh_error_update(preds, target, num_outputs=1)
    return _log_cosh_error_compute(s, n)
