"""MultioutputWrapper: a metric applied to each output column (port of
``metrics_tpu/wrappers/multioutput.py``)."""

from __future__ import annotations

from copy import deepcopy
from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.checks import _value_check_possible


def _get_nan_indices(*tensors: Tensor) -> Tensor:
    """Rows where any of ``tensors`` holds a NaN."""
    if len(tensors) == 0:
        raise ValueError("Must pass at least one tensor as argument")
    sentinel = tensors[0]
    nan_idxs = torch.zeros(len(sentinel), dtype=torch.bool, device=sentinel.device)
    for tensor in tensors:
        permuted = tensor.reshape(len(sentinel), -1)
        nan_idxs = nan_idxs | torch.any(torch.isnan(permuted), dim=1)
    return nan_idxs


class MultioutputWrapper(Metric):
    """Multioutput Wrapper. Dropping the rows with a NaN reads values, so it is
    skipped under :func:`~metrics_tpu_torch.utils.checks.traced` (as a JAX trace
    skips it). It lives on the base metric's device unless ``device`` is given.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MultioutputWrapper, MeanSquaredError
        >>> metric = MultioutputWrapper(MeanSquaredError(device="cpu"), num_outputs=2)
        >>> metric.update(torch.tensor([[1.0, 10.0], [2.0, 20.0]]), torch.tensor([[1.0, 11.0], [2.0, 22.0]]))
        >>> metric.compute()
        tensor([0.0000, 2.5000])
    """

    is_differentiable = False

    def __init__(
        self,
        base_metric: Metric,
        num_outputs: int,
        output_dim: int = -1,
        remove_nans: bool = True,
        squeeze_outputs: bool = True,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("device", getattr(base_metric, "device", None))
        super().__init__(**kwargs)
        self.metrics = [deepcopy(base_metric) for _ in range(num_outputs)]
        self.output_dim = output_dim
        self.remove_nans = remove_nans
        self.squeeze_outputs = squeeze_outputs

    def _get_args_kwargs_by_output(self, *args: Tensor, **kwargs: Tensor):
        """The inputs of each output column."""
        args_kwargs_by_output = []
        for i in range(len(self.metrics)):
            selected_args = [arg.narrow(self.output_dim, i, 1) for arg in args]
            selected_kwargs = {k: v.narrow(self.output_dim, i, 1) for k, v in kwargs.items()}
            if self.remove_nans:
                tensors = selected_args + list(selected_kwargs.values())
                if tensors and _value_check_possible(*tensors):
                    nan_idxs = _get_nan_indices(*tensors)
                    selected_args = [arg[~nan_idxs] for arg in selected_args]
                    selected_kwargs = {k: v[~nan_idxs] for k, v in selected_kwargs.items()}
            if self.squeeze_outputs:
                selected_args = [arg.squeeze(self.output_dim) for arg in selected_args]
                selected_kwargs = {k: v.squeeze(self.output_dim) for k, v in selected_kwargs.items()}
            args_kwargs_by_output.append((selected_args, selected_kwargs))
        return args_kwargs_by_output

    def update(self, *args: Any, **kwargs: Any) -> None:
        reshaped_args_kwargs = self._get_args_kwargs_by_output(*args, **kwargs)
        for metric, (selected_args, selected_kwargs) in zip(self.metrics, reshaped_args_kwargs):
            metric.update(*selected_args, **selected_kwargs)

    def compute(self) -> Tensor:
        return torch.stack([torch.as_tensor(m.compute()) for m in self.metrics], dim=0)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        reshaped_args_kwargs = self._get_args_kwargs_by_output(*args, **kwargs)
        results = [
            metric(*selected_args, **selected_kwargs)
            for metric, (selected_args, selected_kwargs) in zip(self.metrics, reshaped_args_kwargs)
        ]
        if any(r is None for r in results):
            return None
        return torch.stack([torch.as_tensor(r) for r in results], dim=0)

    def reset(self) -> None:
        for metric in self.metrics:
            metric.reset()
        super().reset()

    def to_device(self, device: Any) -> "MultioutputWrapper":
        super().to_device(device)
        for metric in self.metrics:
            metric.to_device(device)
        return self

    def set_dtype(self, dst_type: torch.dtype) -> "MultioutputWrapper":
        for metric in self.metrics:
            metric.set_dtype(dst_type)
        return self
