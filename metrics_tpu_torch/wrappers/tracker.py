"""MetricTracker: a metric (or collection) tracked over epochs or steps
(port of ``metrics_tpu/wrappers/tracker.py``)."""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric, _raise_on_unconsumed
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _host(value: Any) -> np.ndarray:
    """A value as a host numpy array (a tensor on the card is copied)."""
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


class MetricTracker:
    """A list of copies of the metric, one per ``increment()``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MetricTracker, MeanMetric
        >>> tracker = MetricTracker(MeanMetric(device="cpu"))
        >>> tracker.increment()
        >>> tracker.update(torch.tensor(1.0))
        >>> tracker.increment()
        >>> tracker.update(torch.tensor(3.0))
        >>> float(tracker.best_metric())
        3.0
    """

    def __init__(self, metric: Union[Metric, MetricCollection], maximize: Union[bool, List[bool]] = True) -> None:
        if not isinstance(metric, (Metric, MetricCollection)):
            raise TypeError(
                "Metric arg need to be an instance of a metrics_tpu"
                f" `Metric` or `MetricCollection` but got {metric}"
            )
        self._base_metric = metric
        if not isinstance(maximize, (bool, list)):
            raise ValueError("Argument `maximize` should either be a single bool or list of bool")
        if isinstance(maximize, list) and isinstance(metric, MetricCollection) and len(maximize) != len(metric):
            raise ValueError("The len of argument `maximize` should match the length of the metric collection")
        if isinstance(metric, Metric) and not isinstance(maximize, bool):
            raise ValueError("Argument `maximize` should be a single bool when `metric` is a single Metric")
        self.maximize = maximize
        self._increment_called = False
        self._metrics: List[Union[Metric, MetricCollection]] = []

    @property
    def n_steps(self) -> int:
        """Number of tracked steps."""
        return len(self._metrics)

    def increment(self) -> None:
        """Start a new step with a fresh copy of the metric."""
        self._increment_called = True
        self._metrics.append(deepcopy(self._base_metric))
        self._metrics[-1].reset()

    def __len__(self) -> int:
        return len(self._metrics)

    def __getitem__(self, val: int) -> Union[Metric, MetricCollection]:
        return self._metrics[val]

    # ------------------------------------------------------------------ persistence
    # The history grows with each increment, so a snapshot records the step
    # count under ``_n_steps`` and each step under ``_metrics.{i}.``; a load
    # grows (or truncates) the history to that count before restoring it.

    def persistent(self, mode: bool = False) -> None:
        self._base_metric.persistent(mode)
        for m in self._metrics:
            m.persistent(mode)

    def state_dict(self, destination: Optional[Dict[str, Any]] = None, prefix: str = "") -> Dict[str, Any]:
        destination = {} if destination is None else destination
        destination[prefix + "_n_steps"] = np.asarray(len(self._metrics))
        for i, m in enumerate(self._metrics):
            m.state_dict(destination, prefix=f"{prefix}_metrics.{i}.")
        return destination

    def load_state_dict(
        self, state_dict: Dict[str, Any], prefix: str = "", strict: bool = True, _consumed: Optional[set] = None
    ) -> None:
        owns_check = _consumed is None
        consumed: set = set() if owns_check else _consumed
        key = prefix + "_n_steps"
        if key not in state_dict:
            if strict:
                raise KeyError(f"Missing key {key} in state_dict")
            return
        consumed.add(key)
        n = int(np.asarray(state_dict[key]))
        while len(self._metrics) < n:
            self.increment()
        # truncate as well: a tracker that ran past the snapshot keeps none of it
        del self._metrics[n:]
        self._increment_called = n > 0
        for i in range(n):
            self._metrics[i].load_state_dict(state_dict, prefix=f"{prefix}_metrics.{i}.", strict=strict,
                                             _consumed=consumed)
        if owns_check and strict:
            _raise_on_unconsumed(state_dict, prefix, consumed)

    def _check_for_increment(self, method: str) -> None:
        if not self._increment_called:
            raise ValueError(f"`{method}` cannot be called before `.increment()` has been called")

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._check_for_increment("update")
        self._metrics[-1].update(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        self._check_for_increment("forward")
        return self._metrics[-1](*args, **kwargs)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def compute(self) -> Any:
        self._check_for_increment("compute")
        return self._metrics[-1].compute()

    def compute_all(self) -> Any:
        """Every tracked step's value, stacked along a new first dimension."""
        self._check_for_increment("compute_all")
        res = [metric.compute() for metric in self._metrics]
        if isinstance(self._base_metric, MetricCollection):
            keys = res[0].keys()
            return {k: torch.stack([torch.as_tensor(r[k]) for r in res], dim=0) for k in keys}
        return torch.stack([torch.as_tensor(r) for r in res], dim=0)

    def reset(self) -> None:
        """Reset the current step's metric."""
        self._metrics[-1].reset()

    def reset_all(self) -> None:
        for metric in self._metrics:
            metric.reset()

    def best_metric(self, return_step: bool = False) -> Union[Any, Tuple[Any, Any]]:
        """The best value over all tracked steps (and its step), by a host
        argmax / argmin; None, with a warning, where the value is not a scalar."""
        res = self.compute_all()
        if isinstance(self._base_metric, Metric):
            fn = np.argmax if self.maximize else np.argmin
            try:
                value = _host(res)
                idx = int(fn(value))
                if return_step:
                    return float(value[idx]), idx
                return float(value[idx])
            except (ValueError, TypeError) as error:
                rank_zero_warn(
                    f"Encountered the following error when trying to get the best metric: {error}"
                    "this is probably due to the 'best' not being defined for this metric."
                    "Returning `None` instead.", UserWarning,
                )
                if return_step:
                    return None, None
                return None
        maximize = self.maximize if isinstance(self.maximize, list) else len(res) * [self.maximize]
        value, idx = {}, {}
        for i, (k, v) in enumerate(res.items()):
            try:
                fn = np.argmax if maximize[i] else np.argmin
                out = _host(v)
                idx[k] = int(fn(out))
                value[k] = float(out[idx[k]])
            except (ValueError, TypeError) as error:
                rank_zero_warn(
                    f"Encountered the following error when trying to get the best metric for metric {k}:"
                    f"{error} this is probably due to the 'best' not being defined for this metric."
                    "Returning `None` instead.", UserWarning,
                )
                value[k], idx[k] = None, None
        if return_step:
            return value, idx
        return value
