"""Moment-based regression functionals: Pearson, concordance, explained
variance and R² (port of ``metrics_tpu/functional/regression/moments.py``).

Each streams fixed-shape float32 sums (Welford-style means, variances and
co-moments for Pearson and concordance), so the states merge by sum or by the
parallel-variance rule and an update can be captured in a CUDA graph: no
update reads a value on the host or copies one to the card. Plain torch
reductions, no kernel (the JAX package jits them, outside any Pallas kernel).
Every input is cast to float32 first, so float64, float16 and integer inputs
give float32 states and values, as the JAX package's do with x64 off.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape, _value_check_possible
from metrics_tpu_torch.utils.prints import rank_zero_warn

_MULTIOUTPUT = "Argument `multioutput` must be either `raw_values`, `uniform_average` or `variance_weighted`"


def _f32(x: Tensor) -> Tensor:
    return torch.as_tensor(x).to(torch.float32)


# --------------------------------------------------------------------------- pearson


def _pearson_corrcoef_update(
    preds: Tensor,
    target: Tensor,
    mean_x: Tensor,
    mean_y: Tensor,
    var_x: Tensor,
    var_y: Tensor,
    corr_xy: Tensor,
    n_prior: Tensor,
    num_outputs: int,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Parallel Welford update of the means, variances and co-moment."""
    _check_same_shape(preds, target)
    if num_outputs == 1:
        preds = preds.reshape(-1)
        target = target.reshape(-1)
    return _pearson_kernel(preds, target, mean_x, mean_y, var_x, var_y, corr_xy, n_prior)


def _pearson_kernel(
    preds: Tensor,
    target: Tensor,
    mean_x: Tensor,
    mean_y: Tensor,
    var_x: Tensor,
    var_y: Tensor,
    corr_xy: Tensor,
    n_prior: Tensor,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    preds = _f32(preds)
    target = _f32(target)
    n_obs = float(preds.shape[0])  # a Python scalar: no host-to-device copy inside a capture
    mx_new = (n_prior * mean_x + torch.sum(preds, dim=0)) / (n_prior + n_obs)
    my_new = (n_prior * mean_y + torch.sum(target, dim=0)) / (n_prior + n_obs)
    n_total = n_prior + n_obs

    var_x = var_x + torch.sum((preds - mx_new) * (preds - mean_x), dim=0)
    var_y = var_y + torch.sum((target - my_new) * (target - mean_y), dim=0)
    corr_xy = corr_xy + torch.sum((preds - mx_new) * (target - mean_y), dim=0)
    return mx_new, my_new, var_x, var_y, corr_xy, n_total


def _pearson_corrcoef_compute(var_x: Tensor, var_y: Tensor, corr_xy: Tensor, nb: Tensor) -> Tensor:
    """Plain division: a constant input (zero variance) gives 0/0 = NaN, which
    the clip keeps."""
    var_x = var_x / (nb - 1)
    var_y = var_y / (nb - 1)
    corr_xy = corr_xy / (nb - 1)
    corrcoef = corr_xy / torch.sqrt(var_x * var_y)
    return torch.clamp(corrcoef, -1.0, 1.0)


def _zero_moments(preds: Tensor) -> Tuple[Tensor, int]:
    d = preds.shape[1] if preds.ndim == 2 else 1
    return torch.zeros((d,) if d > 1 else (), dtype=torch.float32, device=preds.device), d


def pearson_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Pearson correlation coefficient.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pearson_corrcoef
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> pearson_corrcoef(preds, target)
        tensor(0.9849)
    """
    zeros, d = _zero_moments(preds)
    _, _, var_x, var_y, corr_xy, nb = _pearson_corrcoef_update(
        preds, target, zeros, zeros, zeros, zeros, zeros, zeros.new_zeros(()), num_outputs=d
    )
    return _pearson_corrcoef_compute(var_x, var_y, corr_xy, nb)


# --------------------------------------------------------------------------- concordance


def _concordance_corrcoef_compute(
    mean_x: Tensor, mean_y: Tensor, var_x: Tensor, var_y: Tensor, corr_xy: Tensor, nb: Tensor
) -> Tensor:
    """``2·ρ·σx·σy / (σx² + σy² + (μx − μy)²)`` through the clipped Pearson
    factor, with the n−1-normalised variances."""
    pearson = _pearson_corrcoef_compute(var_x, var_y, corr_xy, nb)
    var_x = var_x / (nb - 1)
    var_y = var_y / (nb - 1)
    return 2.0 * pearson * torch.sqrt(var_x) * torch.sqrt(var_y) / (var_x + var_y + (mean_x - mean_y) ** 2)


def concordance_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Concordance correlation coefficient.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import concordance_corrcoef
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> concordance_corrcoef(preds, target)
        tensor(0.9777)
    """
    zeros, d = _zero_moments(preds)
    mean_x, mean_y, var_x, var_y, corr_xy, nb = _pearson_corrcoef_update(
        preds, target, zeros, zeros, zeros, zeros, zeros, zeros.new_zeros(()), num_outputs=d
    )
    return _concordance_corrcoef_compute(mean_x, mean_y, var_x, var_y, corr_xy, nb)


# --------------------------------------------------------------------------- explained variance


def _explained_variance_update(preds: Tensor, target: Tensor) -> Tuple[int, Tensor, Tensor, Tensor, Tensor]:
    """The number of rows and the four streaming sums, each over rows."""
    _check_same_shape(preds, target)
    preds = _f32(preds)
    target = _f32(target)
    diff = target - preds
    return (
        preds.shape[0],
        torch.sum(diff, dim=0),
        torch.sum(diff * diff, dim=0),
        torch.sum(target, dim=0),
        torch.sum(target * target, dim=0),
    )


def _explained_variance_compute(
    num_obs: Tensor,
    sum_error: Tensor,
    sum_squared_error: Tensor,
    sum_target: Tensor,
    sum_squared_target: Tensor,
    multioutput: str = "uniform_average",
) -> Tensor:
    """sklearn's convention: a zero numerator scores 1, a zero denominator
    under a non-zero numerator scores 0."""
    diff_avg = sum_error / num_obs
    numerator = sum_squared_error / num_obs - diff_avg * diff_avg

    target_avg = sum_target / num_obs
    denominator = sum_squared_target / num_obs - target_avg * target_avg

    nonzero_numerator = numerator != 0
    nonzero_denominator = denominator != 0
    valid_score = nonzero_numerator & nonzero_denominator
    output_scores = torch.ones_like(diff_avg)
    output_scores = torch.where(valid_score, 1.0 - numerator / torch.where(valid_score, denominator, 1.0),
                                output_scores)
    output_scores = torch.where(nonzero_numerator & ~nonzero_denominator, 0.0, output_scores)

    if multioutput == "raw_values":
        return output_scores
    if multioutput == "uniform_average":
        return torch.mean(output_scores)
    if multioutput == "variance_weighted":
        denom_sum = torch.sum(denominator)
        return torch.sum(denominator / denom_sum * output_scores)
    raise ValueError(_MULTIOUTPUT)


def explained_variance(preds: Tensor, target: Tensor, multioutput: str = "uniform_average") -> Tensor:
    """Explained variance.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import explained_variance
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> explained_variance(preds, target)
        tensor(0.9572)
    """
    n, se, sse, st, sst = _explained_variance_update(preds, target)
    return _explained_variance_compute(torch.tensor(float(n), device=se.device), se, sse, st, sst, multioutput)


# --------------------------------------------------------------------------- r2


def _r2_score_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, int]:
    """Sums of the squared targets, the targets and the squared residuals
    (over rows), and the number of rows."""
    _check_same_shape(preds, target)
    preds = _f32(preds)
    target = _f32(target)
    residual = target - preds
    return (
        torch.sum(target * target, dim=0),
        torch.sum(target, dim=0),
        torch.sum(residual * residual, dim=0),
        target.shape[0],
    )


def _r2_score_compute(
    sum_squared_obs: Tensor,
    sum_obs: Tensor,
    residual: Tensor,
    num_obs: Tensor,
    adjusted: int = 0,
    multioutput: str = "uniform_average",
) -> Tensor:
    """R² from the streamed sums, with the adjusted variant; a degenerate
    adjustment warns and falls back to the plain score."""
    if _value_check_possible(num_obs) and num_obs < 2:
        raise ValueError("Needs at least two samples to calculate r2 score.")
    mean_obs = sum_obs / num_obs
    tss = sum_squared_obs - sum_obs * mean_obs
    # plain division: a constant target gives tss == 0 and -inf (or NaN)
    raw_scores = 1 - (residual / tss)

    if multioutput == "raw_values":
        r2 = raw_scores
    elif multioutput == "uniform_average":
        r2 = torch.mean(raw_scores)
    elif multioutput == "variance_weighted":
        tss_sum = torch.sum(tss)
        r2 = torch.sum(tss / tss_sum * raw_scores)
    else:
        raise ValueError(_MULTIOUTPUT)

    if adjusted < 0 or not isinstance(adjusted, int):
        raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
    if adjusted != 0:
        if _value_check_possible(num_obs):
            if adjusted > num_obs - 1:
                rank_zero_warn(
                    "More independent regressions than data points in adjusted r2 score. "
                    "Falls back to standard r2 score.",
                    UserWarning,
                )
            elif adjusted == num_obs - 1:
                rank_zero_warn("Division by zero in adjusted r2 score. Falls back to standard r2 score.", UserWarning)
            else:
                return 1 - (1 - r2) * (num_obs - 1) / (num_obs - adjusted - 1)
            return r2
        adjusted_r2 = 1 - (1 - r2) * (num_obs - 1) / (num_obs - adjusted - 1)
        return torch.where(num_obs - adjusted - 1 > 0, adjusted_r2, r2)
    return r2


def r2_score(preds: Tensor, target: Tensor, adjusted: int = 0, multioutput: str = "uniform_average") -> Tensor:
    """R² score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import r2_score
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> r2_score(preds, target)
        tensor(0.9486)
    """
    sum_squared_obs, sum_obs, residual, num_obs = _r2_score_update(preds, target)
    if num_obs < 2:
        raise ValueError("Needs at least two samples to calculate r2 score.")
    n = torch.tensor(float(num_obs), device=residual.device)
    return _r2_score_compute(sum_squared_obs, sum_obs, residual, n, adjusted, multioutput)
