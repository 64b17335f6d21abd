"""Regression functionals (port of ``metrics_tpu/functional/regression``): the
error sums of ``basic.py`` so far."""

from metrics_tpu_torch.functional.regression.basic import (
    log_cosh_error,
    mean_absolute_error,
    mean_absolute_percentage_error,
    mean_squared_error,
    mean_squared_log_error,
    symmetric_mean_absolute_percentage_error,
    weighted_mean_absolute_percentage_error,
)

__all__ = [
    "log_cosh_error",
    "mean_absolute_error",
    "mean_absolute_percentage_error",
    "mean_squared_error",
    "mean_squared_log_error",
    "symmetric_mean_absolute_percentage_error",
    "weighted_mean_absolute_percentage_error",
]
