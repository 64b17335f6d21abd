"""Exact match module metrics: multiclass and multilabel, and the
``ExactMatch`` task façade (port of ``metrics_tpu/classification/exact_match.py``).

``multidim_average="global"`` keeps an int32 ``correct`` and a float32
``total`` summed over updates; ``"samplewise"`` keeps ``correct`` as a list
state of per-sample flags, read through ``dim_zero_cat``."""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.exact_match import (
    _exact_match_reduce,
    _multiclass_exact_match_update,
    _multilabel_exact_match_update,
)
from metrics_tpu_torch.functional.classification.stat_scores import (
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_tensor_validation,
)
from metrics_tpu_torch.metric import Metric, zero_state
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.enums import ClassificationTask


class _AbstractExactMatch(Metric):
    correct: Any
    total: Tensor
    multidim_average: str

    def _create_state(self, multidim_average: str) -> None:
        if multidim_average == "samplewise":
            self.add_state("correct", [], dist_reduce_fx="cat")
        else:
            self.add_state("correct", zero_state((), torch.int32, self.device), dist_reduce_fx="sum")
        self.add_state("total", zero_state((), torch.float32, self.device), dist_reduce_fx="sum")

    def _update_state(self, correct: Tensor) -> None:
        if isinstance(self.correct, list):
            self.correct.append(correct)
        else:
            self.correct = self.correct + torch.sum(correct, dtype=torch.int32)
        self.total = self.total + correct.numel()

    def compute(self) -> Tensor:
        correct = dim_zero_cat(self.correct) if isinstance(self.correct, list) else self.correct
        return _exact_match_reduce(correct, self.total, self.multidim_average)


class MulticlassExactMatch(_AbstractExactMatch):
    """Share of samples whose every position is correct.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MulticlassExactMatch
        >>> metric = MulticlassExactMatch(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([[0, 1], [2, 0]]), torch.tensor([[0, 1], [2, 1]]))
        >>> metric.compute()
        tensor(0.5000)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        num_classes: int,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_stat_scores_arg_validation(num_classes, top_k=1, average=None,
                                                   multidim_average=multidim_average, ignore_index=ignore_index)
        self.num_classes = num_classes
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(preds, target, self.num_classes, self.multidim_average,
                                                      self.ignore_index)
        self._update_state(_multiclass_exact_match_update(preds, target, self.ignore_index))


class MultilabelExactMatch(_AbstractExactMatch):
    """Multilabel exact match.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MultilabelExactMatch
        >>> metric = MultilabelExactMatch(num_labels=3, device="cpu")
        >>> metric.update(torch.tensor([[1, 0, 1], [0, 1, 0], [1, 1, 0], [0, 0, 1]]),
        ...               torch.tensor([[1, 0, 0], [0, 1, 0], [1, 0, 0], [0, 1, 1]]))
        >>> metric.compute()
        tensor(0.2500)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_stat_scores_arg_validation(num_labels, threshold, average=None,
                                                   multidim_average=multidim_average, ignore_index=ignore_index)
        self.num_labels = num_labels
        self.threshold = threshold
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multilabel_stat_scores_tensor_validation(preds, target, self.num_labels, self.multidim_average,
                                                      self.ignore_index)
        self._update_state(
            _multilabel_exact_match_update(preds, target, self.num_labels, self.threshold, self.ignore_index)
        )


class ExactMatch:
    """Task-dispatch façade: ``__new__`` returns the task's exact match.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import ExactMatch
        >>> metric = ExactMatch(task="multiclass", num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([[0, 2], [1, 1]]), torch.tensor([[0, 2], [1, 0]]))
        >>> metric.compute()
        tensor(0.5000)
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str_or_raise(task)
        kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.MULTICLASS:
            assert isinstance(num_classes, int)
            return MulticlassExactMatch(num_classes, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            assert isinstance(num_labels, int)
            return MultilabelExactMatch(num_labels, threshold, **kwargs)
        raise ValueError(f"Expected argument `task` to either be 'multiclass' or 'multilabel' but got {task}")
