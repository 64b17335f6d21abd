"""Regression module metrics (port of ``metrics_tpu/regression``): the error
sums of ``basic.py`` so far."""

from metrics_tpu_torch.regression.basic import (
    LogCoshError,
    MeanAbsoluteError,
    MeanAbsolutePercentageError,
    MeanSquaredError,
    MeanSquaredLogError,
    SymmetricMeanAbsolutePercentageError,
    WeightedMeanAbsolutePercentageError,
)

__all__ = [
    "LogCoshError",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "SymmetricMeanAbsolutePercentageError",
    "WeightedMeanAbsolutePercentageError",
]
