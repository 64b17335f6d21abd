"""ClasswiseWrapper: a per-class result as a dict labelled by class (port of
``metrics_tpu/wrappers/classwise.py``)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from torch import Tensor

from metrics_tpu_torch.metric import Metric


class ClasswiseWrapper(Metric):
    """Classwise Wrapper: keys are the wrapped metric's lowercased class name
    and ``_{label}`` (the class index, or the given label). It lives on the
    wrapped metric's device unless ``device`` is given.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ClasswiseWrapper
        >>> from metrics_tpu_torch.classification import MulticlassAccuracy
        >>> metric = ClasswiseWrapper(MulticlassAccuracy(num_classes=3, average=None, device="cpu"))
        >>> metric.update(torch.tensor([0, 1, 2, 1]), torch.tensor([0, 1, 2, 2]))
        >>> {k: float(v) for k, v in metric.compute().items()}
        {'multiclassaccuracy_0': 1.0, 'multiclassaccuracy_1': 1.0, 'multiclassaccuracy_2': 0.5}
    """

    full_state_update: Optional[bool] = True

    def __init__(self, metric: Metric, labels: Optional[List[str]] = None, **kwargs: Any) -> None:
        if not isinstance(metric, Metric):
            raise ValueError(f"Expected argument `metric` to be an instance of `metrics_tpu.Metric` but got {metric}")
        kwargs.setdefault("device", metric.device)
        super().__init__(**kwargs)
        if labels is not None and not (isinstance(labels, list) and all(isinstance(lab, str) for lab in labels)):
            raise ValueError(f"Expected argument `labels` to either be `None` or a list of strings but got {labels}")
        self.metric = metric
        self.labels = labels

    def _convert(self, x: Tensor) -> Dict[str, Tensor]:
        name = self.metric.__class__.__name__.lower()
        if self.labels is None:
            return {f"{name}_{i}": val for i, val in enumerate(x)}
        return {f"{name}_{lab}": val for lab, val in zip(self.labels, x)}

    def update(self, *args: Any, **kwargs: Any) -> None:
        self.metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, Tensor]:
        return self._convert(self.metric.compute())

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        return self._convert(self.metric(*args, **kwargs))

    def reset(self) -> None:
        self.metric.reset()

    def to_device(self, device: Any) -> "ClasswiseWrapper":
        super().to_device(device)
        self.metric.to_device(device)
        return self

    def set_dtype(self, dst_type: Any) -> "ClasswiseWrapper":
        self.metric.set_dtype(dst_type)
        return self

    def _wrap_update(self, update: Callable) -> Callable:  # the wrapped metric keeps its own bookkeeping
        return update

    def _wrap_compute(self, compute: Callable) -> Callable:
        return compute
