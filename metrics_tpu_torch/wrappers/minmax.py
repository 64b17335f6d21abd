"""MinMaxMetric: the running minimum and maximum of a base metric's value
(port of ``metrics_tpu/wrappers/minmax.py``)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.metric import Metric, _as_state_tensor, _raise_on_unconsumed


def _as_value(val: Union[float, int, Tensor], device: torch.device) -> Tensor:
    """``jnp.asarray(val)`` with x64 off: a Python int is int32, a float
    float32, on ``device``."""
    if isinstance(val, Tensor):
        return val
    return torch.tensor(val, dtype=torch.int32 if isinstance(val, int) else torch.float32, device=device)


class MinMaxMetric(Metric):
    """Min Max Metric. It lives on the base metric's device unless ``device`` is given.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MinMaxMetric, MeanMetric
        >>> metric = MinMaxMetric(MeanMetric(device="cpu"))
        >>> metric.update(torch.tensor(2.0))
        >>> {k: float(v) for k, v in metric.compute().items()}
        {'raw': 2.0, 'max': 2.0, 'min': 2.0}
        >>> metric.update(torch.tensor(4.0))
        >>> {k: float(v) for k, v in metric.compute().items()}
        {'raw': 3.0, 'max': 3.0, 'min': 2.0}
    """

    full_state_update: Optional[bool] = True

    min_val: Tensor
    max_val: Tensor

    def __init__(self, base_metric: Metric, **kwargs: Any) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of `metrics_tpu.Metric` but received {base_metric}"
            )
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self._base_metric = base_metric
        # plain attributes, not registered states: they change inside compute(),
        # and forward()'s snapshot and restore of registered states would undo
        # that. state_dict and load_state_dict carry them explicitly.
        self.min_val = torch.tensor(float("inf"), device=self.device)
        self.max_val = torch.tensor(float("-inf"), device=self.device)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._base_metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, Tensor]:
        """The base metric's value and the running extremes (float32)."""
        val = self._base_metric.compute()
        if not self._is_suitable_val(val):
            raise RuntimeError(f"Returned value from base metric should be a float or scalar tensor, but got {val}")
        as32 = torch.as_tensor(val, dtype=torch.float32, device=self.device)
        self.max_val = torch.where(self.max_val > as32, self.max_val, as32)
        self.min_val = torch.where(self.min_val < as32, self.min_val, as32)
        return {"raw": _as_value(val, self.device), "max": self.max_val, "min": self.min_val}

    def reset(self) -> None:
        """Reset the base metric. The running extremes are kept, as in the
        reference (its docstring says they reset, its body does not), and
        ``forward`` relies on it: its full-state path calls ``reset()``."""
        super().reset()
        self._base_metric.reset()

    def to_device(self, device: Any) -> "MinMaxMetric":
        super().to_device(device)
        self._base_metric.to_device(device)
        self.min_val, self.max_val = self.min_val.to(self.device), self.max_val.to(self.device)
        return self

    def set_dtype(self, dst_type: torch.dtype) -> "MinMaxMetric":
        self._base_metric.set_dtype(dst_type)
        return self

    def state_dict(self, destination: Optional[Dict] = None, prefix: str = "") -> Dict[str, Any]:
        destination = super().state_dict(destination, prefix)  # recurses into _base_metric
        if self._any_persistent():  # recursive: the base may itself be a wrapper
            destination[prefix + "min_val"] = self.min_val.detach().clone()
            destination[prefix + "max_val"] = self.max_val.detach().clone()
        return destination

    def load_state_dict(
        self, state_dict: Dict[str, Any], prefix: str = "", strict: bool = True, _consumed: Optional[set] = None
    ) -> None:
        owns_check = _consumed is None
        consumed: set = set() if owns_check else _consumed
        super().load_state_dict(state_dict, prefix, strict, _consumed=consumed)
        for key in ("min_val", "max_val"):
            name = prefix + key
            if name in state_dict:
                consumed.add(name)
                setattr(self, key, _as_state_tensor(state_dict[name], self.device))
            elif strict and self._any_persistent():
                raise KeyError(f"Missing key {name} in state_dict")
        if owns_check and strict:
            _raise_on_unconsumed(state_dict, prefix, consumed)

    @staticmethod
    def _is_suitable_val(val: Union[float, Tensor]) -> bool:
        if isinstance(val, (int, float)):
            return True
        if isinstance(val, Tensor):
            return val.numel() == 1
        return False
