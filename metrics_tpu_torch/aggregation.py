"""Streaming scalar aggregators (port of ``metrics_tpu/aggregation.py``).

``nan_strategy`` keeps the JAX package's meanings. "error" and "warn" read
whether the batch holds a NaN on the host (one device sync per update on the
GPU) and "warn" then filters the NaNs out; "ignore" and a float imputation mask
with ``torch.where`` and never sync, except in ``CatMetric``, whose "ignore"
filter keeps a data-dependent number of values. Values and weights are
float32, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.metric import Metric, zero_state
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.prints import rank_zero_warn


class BaseAggregator(Metric):
    """Base class for aggregators."""

    is_differentiable = None
    higher_is_better = None
    full_state_update = False
    _neutral: float = 0.0  # the value NaNs map to under nan_strategy='ignore'

    def __init__(
        self,
        fn: Union[Callable, str],
        default_value: Union[Tensor, List],
        nan_strategy: Union[str, float] = "error",
        state_name: str = "value",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_nan_strategy = ("error", "warn", "ignore")
        if nan_strategy not in allowed_nan_strategy and not isinstance(nan_strategy, float):
            raise ValueError(
                f"Arg `nan_strategy` should either be a float or one of {allowed_nan_strategy} but got {nan_strategy}."
            )
        self.nan_strategy = nan_strategy
        self.add_state(state_name, default=default_value, dist_reduce_fx=fn)
        self.state_name = state_name

    def _cast_and_nan_check_input(
        self, x: Union[float, Tensor], weight: Optional[Union[float, Tensor]] = None
    ) -> Tuple[Tensor, Tensor]:
        """``(x, weight)`` as flat float32 tensors on the metric's device, NaNs
        handled per ``nan_strategy`` (under "ignore" a NaN becomes the
        operation's neutral value with weight 0)."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if weight is not None:
            weight = torch.as_tensor(weight, dtype=torch.float32, device=self.device)
            weight = torch.broadcast_to(weight, x.shape)

        nans = torch.isnan(x)
        if self.nan_strategy in ("error", "warn"):
            if bool(nans.any()):
                if self.nan_strategy == "error":
                    raise RuntimeError("Encountered `nan` values in tensor")
                rank_zero_warn("Encountered `nan` values in tensor. Will be removed.", UserWarning)
                x = x[~nans]
                if weight is not None:
                    weight = weight[~nans]
        elif self.nan_strategy == "ignore":
            weight = torch.ones_like(x) if weight is None else weight
            weight = torch.where(nans, torch.zeros((), dtype=weight.dtype, device=weight.device), weight)
            x = torch.where(nans, torch.tensor(self._neutral, dtype=x.dtype, device=x.device), x)
        else:  # float imputation
            x = torch.where(nans, torch.tensor(self.nan_strategy, dtype=x.dtype, device=x.device), x)

        if weight is None:
            weight = torch.ones_like(x)
        return x.reshape(-1), weight.reshape(-1)

    def update(self, value: Union[float, Tensor]) -> None:
        pass

    def compute(self) -> Tensor:
        return getattr(self, self.state_name)


class MaxMetric(BaseAggregator):
    """Running max.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MaxMetric
        >>> metric = MaxMetric(device="cpu")
        >>> metric.update(torch.tensor([1.0, 3.0, 2.0]))
        >>> metric.compute()
        tensor(3.)
    """

    full_state_update = True
    _neutral = -float("inf")

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__(
            "max", torch.tensor(-float("inf"), dtype=torch.float32), nan_strategy, state_name="max_value", **kwargs
        )

    def update(self, value: Union[float, Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        if value.numel():  # a batch whose every value was a filtered NaN contributes nothing
            self.max_value = torch.maximum(self.max_value, torch.max(value))


class MinMetric(BaseAggregator):
    """Running min.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MinMetric
        >>> metric = MinMetric(device="cpu")
        >>> metric.update(torch.tensor([1.0, 3.0, 2.0]))
        >>> metric.compute()
        tensor(1.)
    """

    full_state_update = True
    _neutral = float("inf")

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__(
            "min", torch.tensor(float("inf"), dtype=torch.float32), nan_strategy, state_name="min_value", **kwargs
        )

    def update(self, value: Union[float, Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        if value.numel():
            self.min_value = torch.minimum(self.min_value, torch.min(value))


class SumMetric(BaseAggregator):
    """Running sum.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SumMetric
        >>> metric = SumMetric(device="cpu")
        >>> metric.update(torch.tensor([1.0, 3.0, 2.0]))
        >>> metric.update(4.0)
        >>> metric.compute()
        tensor(10.)
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.zeros((), dtype=torch.float32), nan_strategy, state_name="sum_value", **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        if value.numel():
            self.sum_value = self.sum_value + torch.sum(value)


class CatMetric(BaseAggregator):
    """Concatenate all seen values.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CatMetric
        >>> metric = CatMetric(device="cpu")
        >>> metric.update(torch.tensor([1.0, 2.0]))
        >>> metric.update(torch.tensor([3.0]))
        >>> metric.compute()
        tensor([1., 2., 3.])
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("cat", [], nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value, weight = self._cast_and_nan_check_input(value)
        if self.nan_strategy == "ignore":
            value = value[weight != 0]
        if value.numel():
            self.value.append(value)

    def compute(self) -> Union[Tensor, List]:
        if isinstance(self.value, list) and self.value:
            return dim_zero_cat(self.value)
        return self.value


class MeanMetric(BaseAggregator):
    """Weighted running mean: ``mean_value`` and ``weight`` sum states.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanMetric
        >>> metric = MeanMetric(device="cpu")
        >>> metric.update(torch.tensor([1.0, 2.0, 3.0]))
        >>> metric.update(5.0, weight=3.0)
        >>> metric.compute()
        tensor(3.5000)
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.zeros((), dtype=torch.float32), nan_strategy, state_name="mean_value", **kwargs)
        self.add_state("weight", default=zero_state((), torch.float32, self.device), dist_reduce_fx="sum")

    def update(self, value: Union[float, Tensor], weight: Union[float, Tensor] = 1.0) -> None:
        value, weight = self._cast_and_nan_check_input(value, weight)
        if value.numel() == 0:
            return
        self.mean_value = self.mean_value + torch.sum(value * weight)
        self.weight = self.weight + torch.sum(weight)

    def compute(self) -> Tensor:
        return self.mean_value / self.weight


__all__ = ["BaseAggregator", "MaxMetric", "MinMetric", "SumMetric", "CatMetric", "MeanMetric"]
