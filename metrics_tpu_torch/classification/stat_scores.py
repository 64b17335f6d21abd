"""Stat-scores module metrics: binary, multiclass and multilabel, and the
``StatScores`` task façade (port of ``metrics_tpu/classification/stat_scores.py``).

State regimes: ``multidim_average="global"`` gives fixed-shape int32 tensor
states reduced by "sum" (scalars for binary, ``(C,)`` otherwise);
``"samplewise"`` gives list states reduced by "cat".
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_compute,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
    _binary_stat_scores_update,
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_compute,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multiclass_stat_scores_update,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_compute,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
    _multilabel_stat_scores_update,
)
from metrics_tpu_torch.metric import Metric, zero_state
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.enums import ClassificationTask


class _AbstractStatScores(Metric):
    """Shared tp/fp/tn/fn state plumbing."""

    tp: Any
    fp: Any
    tn: Any
    fn: Any

    def _create_state(self, size: int, multidim_average: str = "global") -> None:
        """tensor + "sum" states for global, list + "cat" states for samplewise."""
        for s in ("tp", "fp", "tn", "fn"):
            if multidim_average == "samplewise":
                self.add_state(s, [], dist_reduce_fx="cat")
            else:
                shape = () if size == 1 else (size,)
                self.add_state(s, zero_state(shape, dtype=torch.int32, device=self.device), dist_reduce_fx="sum")

    def _update_state(self, tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> None:
        """Accumulate: a new tensor for tensor states, an append for list states."""
        if isinstance(self.tp, list):
            self.tp.append(tp)
            self.fp.append(fp)
            self.tn.append(tn)
            self.fn.append(fn)
        else:
            self.tp = self.tp + tp
            self.fp = self.fp + fp
            self.tn = self.tn + tn
            self.fn = self.fn + fn

    def _final_state(self) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """Final aggregated state (list states concatenated)."""
        return tuple(dim_zero_cat(s) if isinstance(s, list) else s for s in (self.tp, self.fp, self.tn, self.fn))


class BinaryStatScores(_AbstractStatScores):
    """tp/fp/tn/fn counts plus support for binary tasks.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import BinaryStatScores
        >>> metric = BinaryStatScores(device="cpu")
        >>> metric.update(torch.tensor([0, 0, 1, 1, 0, 1]), torch.tensor([0, 1, 0, 1, 0, 1]))
        >>> metric.compute()  # [tp, fp, tn, fn, support]
        tensor([2, 1, 2, 1, 3], dtype=torch.int32)
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        self.threshold = threshold
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(size=1, multidim_average=multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _binary_stat_scores_tensor_validation(preds, target, self.multidim_average, self.ignore_index)
        preds, target, mask = _binary_stat_scores_format(preds, target, self.threshold, self.ignore_index)
        tp, fp, tn, fn = _binary_stat_scores_update(preds, target, mask, self.multidim_average)
        self._update_state(tp, fp, tn, fn)

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _binary_stat_scores_compute(tp, fp, tn, fn, self.multidim_average)


class MulticlassStatScores(_AbstractStatScores):
    """Per-class tp/fp/tn/fn/support for multiclass tasks.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MulticlassStatScores
        >>> metric = MulticlassStatScores(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]))
        >>> metric.compute()
        tensor([[1, 0, 3, 0, 1],
                [1, 0, 2, 1, 2],
                [1, 1, 2, 0, 1]], dtype=torch.int32)
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: int,
        top_k: int = 1,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        self.num_classes = num_classes
        self.top_k = top_k
        self.average = average
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        # states are always per-class (C,); the micro sum happens in compute
        self._create_state(size=num_classes, multidim_average=multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(preds, target, self.num_classes, self.multidim_average, self.ignore_index)
        preds, target = _multiclass_stat_scores_format(preds, target, self.top_k)
        tp, fp, tn, fn = _multiclass_stat_scores_update(
            preds, target, self.num_classes, self.top_k, self.average, self.multidim_average, self.ignore_index
        )
        self._update_state(tp, fp, tn, fn)

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _multiclass_stat_scores_compute(tp, fp, tn, fn, self.average, self.multidim_average)


class MultilabelStatScores(_AbstractStatScores):
    """Per-label tp/fp/tn/fn/support for multilabel tasks.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MultilabelStatScores
        >>> metric = MultilabelStatScores(num_labels=3, device="cpu")
        >>> metric.update(torch.tensor([[1, 0, 1], [0, 1, 0], [1, 1, 0], [0, 0, 1]]),
        ...               torch.tensor([[1, 0, 0], [0, 1, 0], [1, 0, 0], [0, 1, 1]]))
        >>> metric.compute()
        tensor([[2, 0, 2, 0, 2],
                [1, 1, 1, 1, 2],
                [1, 1, 2, 0, 1]], dtype=torch.int32)
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        self.num_labels = num_labels
        self.threshold = threshold
        self.average = average
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(size=num_labels, multidim_average=multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multilabel_stat_scores_tensor_validation(preds, target, self.num_labels, self.multidim_average, self.ignore_index)
        preds, target, mask = _multilabel_stat_scores_format(preds, target, self.num_labels, self.threshold, self.ignore_index)
        tp, fp, tn, fn = _multilabel_stat_scores_update(preds, target, mask, self.multidim_average)
        self._update_state(tp, fp, tn, fn)

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _multilabel_stat_scores_compute(tp, fp, tn, fn, self.average, self.multidim_average)


def _task_metric(task: str, classes: tuple, threshold: float, num_classes: Optional[int], num_labels: Optional[int],
                 average: Optional[str], top_k: int, kwargs: dict) -> Metric:
    """The task façades' shared ``__new__`` body: the binary, multiclass or
    multilabel class of ``classes`` for ``task``, as the JAX package builds it."""
    task = ClassificationTask.from_str_or_raise(task)
    binary, multiclass, multilabel = classes
    if task == ClassificationTask.BINARY:
        return binary(threshold, **kwargs)
    if task == ClassificationTask.MULTICLASS:
        assert isinstance(num_classes, int)
        assert isinstance(top_k, int)
        return multiclass(num_classes, top_k, average, **kwargs)
    if task == ClassificationTask.MULTILABEL:
        assert isinstance(num_labels, int)
        return multilabel(num_labels, threshold, average, **kwargs)
    raise ValueError(f"Not handled value: {task}")


class StatScores:
    """Task-dispatch façade: ``__new__`` returns the task's metric.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import StatScores
        >>> metric = StatScores(task="multiclass", num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]))
        >>> metric.compute()
        tensor([3, 1, 7, 1, 4], dtype=torch.int32)
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: int = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        assert multidim_average is not None
        kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args})
        return _task_metric(task, (BinaryStatScores, MulticlassStatScores, MultilabelStatScores), threshold,
                            num_classes, num_labels, average, top_k, kwargs)
