"""Error-sum regression module metrics: MAE, MSE, MAPE, SMAPE, WMAPE, MSLE and
LogCosh (port of ``metrics_tpu/regression/basic.py``).

Each holds two float32 sum states reduced by "sum": an error sum and the
number of observations (``total`` is float32, as in the JAX package). Each
update adds onto the states, so the serving engine can capture it.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.functional.regression.basic import (
    _log_cosh_error_compute,
    _log_cosh_error_update,
    _mean_absolute_error_compute,
    _mean_absolute_error_update,
    _mean_absolute_percentage_error_compute,
    _mean_absolute_percentage_error_update,
    _mean_squared_error_compute,
    _mean_squared_error_update,
    _mean_squared_log_error_update,
    _symmetric_mean_absolute_percentage_error_update,
    _weighted_mean_absolute_percentage_error_compute,
    _weighted_mean_absolute_percentage_error_update,
)
from metrics_tpu_torch.metric import Metric, zero_state


class _ErrorSum(Metric):
    """Two float32 sum states, ``error_state`` and ``count_state``."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def _add_sum_states(self, error_state: str, count_state: str, error_shape: Any = ()) -> None:
        self.add_state(error_state, zero_state(error_shape, torch.float32, device=self.device), dist_reduce_fx="sum")
        self.add_state(count_state, zero_state((), torch.float32, device=self.device), dist_reduce_fx="sum")

    def _accumulate(self, **increments: Any) -> None:
        """Add each increment onto the same-named float32 state, cast to the
        state's dtype first (a float64 increment would otherwise promote the
        state; the JAX package keeps it float32 with x64 off)."""
        for name, value in increments.items():
            state = getattr(self, name)
            if isinstance(value, torch.Tensor):
                value = value.to(state.dtype)
            setattr(self, name, state + value)


class MeanAbsoluteError(_ErrorSum):
    """Mean Absolute Error.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanAbsoluteError
        >>> metric = MeanAbsoluteError(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> metric.compute()
        tensor(0.5000)
    """

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._add_sum_states("sum_abs_error", "total")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_abs_error, num_obs = _mean_absolute_error_update(preds, target)
        self._accumulate(sum_abs_error=sum_abs_error, total=num_obs)

    def compute(self) -> Tensor:
        return _mean_absolute_error_compute(self.sum_abs_error, self.total)


class MeanSquaredError(_ErrorSum):
    """Mean Squared Error, or its root with ``squared=False``; with
    ``num_outputs > 1`` one error sum per output column.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanSquaredError
        >>> metric = MeanSquaredError(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> metric.compute()
        tensor(0.3750)
    """

    def __init__(self, squared: bool = True, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(squared, bool):
            raise ValueError(f"Expected argument `squared` to be a boolean but got {squared}")
        self.squared = squared
        if not (isinstance(num_outputs, int) and num_outputs > 0):
            raise ValueError(f"Expected num_outputs to be a positive integer but got {num_outputs}")
        self.num_outputs = num_outputs
        self._add_sum_states("sum_squared_error", "total", () if num_outputs == 1 else (num_outputs,))

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_error, num_obs = _mean_squared_error_update(preds, target, self.num_outputs)
        self._accumulate(sum_squared_error=sum_squared_error, total=num_obs)

    def compute(self) -> Tensor:
        return _mean_squared_error_compute(self.sum_squared_error, self.total, self.squared)


class MeanAbsolutePercentageError(_ErrorSum):
    """Mean Absolute Percentage Error.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanAbsolutePercentageError
        >>> metric = MeanAbsolutePercentageError(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> metric.compute()
        tensor(0.3274)
    """

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._add_sum_states("sum_abs_per_error", "total")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_abs_per_error, num_obs = _mean_absolute_percentage_error_update(preds, target)
        self._accumulate(sum_abs_per_error=sum_abs_per_error, total=num_obs)

    def compute(self) -> Tensor:
        return _mean_absolute_percentage_error_compute(self.sum_abs_per_error, self.total)


class SymmetricMeanAbsolutePercentageError(_ErrorSum):
    """Symmetric Mean Absolute Percentage Error.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SymmetricMeanAbsolutePercentageError
        >>> metric = SymmetricMeanAbsolutePercentageError(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> metric.compute()
        tensor(0.5788)
    """

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._add_sum_states("sum_abs_per_error", "total")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_abs_per_error, num_obs = _symmetric_mean_absolute_percentage_error_update(preds, target)
        self._accumulate(sum_abs_per_error=sum_abs_per_error, total=num_obs)

    def compute(self) -> Tensor:
        return self.sum_abs_per_error / self.total


class WeightedMeanAbsolutePercentageError(_ErrorSum):
    """Weighted Mean Absolute Percentage Error.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import WeightedMeanAbsolutePercentageError
        >>> metric = WeightedMeanAbsolutePercentageError(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> metric.compute()
        tensor(0.1600)
    """

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._add_sum_states("sum_abs_error", "sum_scale")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_abs_error, sum_scale = _weighted_mean_absolute_percentage_error_update(preds, target)
        self._accumulate(sum_abs_error=sum_abs_error, sum_scale=sum_scale)

    def compute(self) -> Tensor:
        return _weighted_mean_absolute_percentage_error_compute(self.sum_abs_error, self.sum_scale)


class MeanSquaredLogError(_ErrorSum):
    """Mean Squared Log Error.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanSquaredLogError
        >>> metric = MeanSquaredLogError(device="cpu")
        >>> metric.update(torch.tensor([2.5, 5.0, 4.0, 8.0]), torch.tensor([3.0, 5.0, 2.5, 7.0]))
        >>> round(float(metric.compute()), 4)
        0.0397
    """

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._add_sum_states("sum_squared_log_error", "total")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_log_error, num_obs = _mean_squared_log_error_update(preds, target)
        self._accumulate(sum_squared_log_error=sum_squared_log_error, total=num_obs)

    def compute(self) -> Tensor:
        return self.sum_squared_log_error / self.total


class LogCoshError(_ErrorSum):
    """Log Cosh Error, one error sum per output column.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import LogCoshError
        >>> metric = LogCoshError(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(metric.compute()), 4)
        0.1685
    """

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(num_outputs, int) and num_outputs > 0):
            raise ValueError(f"Expected num_outputs to be a positive integer but got {num_outputs}")
        self.num_outputs = num_outputs
        self._add_sum_states("sum_log_cosh_error", "total", (num_outputs,))

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_log_cosh_error, num_obs = _log_cosh_error_update(preds, target, self.num_outputs)
        self._accumulate(sum_log_cosh_error=sum_log_cosh_error, total=num_obs)

    def compute(self) -> Tensor:
        return _log_cosh_error_compute(self.sum_log_cosh_error, self.total)
