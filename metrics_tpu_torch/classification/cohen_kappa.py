"""Cohen's kappa module metrics: binary and multiclass, and the ``CohenKappa``
task façade (port of ``metrics_tpu/classification/cohen_kappa.py``). Each is
its confusion matrix with a kappa ``compute``."""

from __future__ import annotations

from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.confusion_matrix import BinaryConfusionMatrix, MulticlassConfusionMatrix
from metrics_tpu_torch.functional.classification.cohen_kappa import _cohen_kappa_reduce
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.enums import ClassificationTask


class BinaryCohenKappa(BinaryConfusionMatrix):
    """Cohen's kappa: agreement corrected for chance.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import BinaryCohenKappa
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> preds = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> metric = BinaryCohenKappa(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.3333)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        weights: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(threshold, ignore_index, normalize=None, validate_args=validate_args, **kwargs)
        self.weights = weights

    def compute(self) -> Tensor:
        return _cohen_kappa_reduce(self.confmat, self.weights)


class MulticlassCohenKappa(MulticlassConfusionMatrix):
    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        ignore_index: Optional[int] = None,
        weights: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes, ignore_index, normalize=None, validate_args=validate_args, **kwargs)
        self.weights = weights

    def compute(self) -> Tensor:
        return _cohen_kappa_reduce(self.confmat, self.weights)


class CohenKappa:
    """Task-dispatch façade: ``__new__`` returns the task's Cohen's kappa.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import CohenKappa
        >>> metric = CohenKappa(task="multiclass", num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]))
        >>> metric.compute()
        tensor(0.6364)
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        weights: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str_or_raise(task)
        kwargs.update({"weights": weights, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryCohenKappa(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            assert isinstance(num_classes, int)
            return MulticlassCohenKappa(num_classes, **kwargs)
        raise ValueError(f"Expected argument `task` to either be 'binary' or 'multiclass' but got {task}")
