"""F-beta / F1 module metrics: binary, multiclass and multilabel, and the
``FBetaScore`` and ``F1Score`` task façades (port of ``metrics_tpu/classification/f_beta.py``)."""

from __future__ import annotations

import functools
from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    _task_metric,
)
from metrics_tpu_torch.functional.classification.f_beta import _fbeta_reduce, _validate_beta
from metrics_tpu_torch.functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _multiclass_stat_scores_arg_validation,
    _multilabel_stat_scores_arg_validation,
)
from metrics_tpu_torch.metric import Metric


class BinaryFBetaScore(BinaryStatScores):
    """F-beta for binary tasks over tp/fp/tn/fn sum states.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import BinaryFBetaScore
        >>> metric = BinaryFBetaScore(beta=2.0, device="cpu")
        >>> metric.update(torch.tensor([0, 0, 1, 1, 0, 1]), torch.tensor([0, 1, 0, 1, 0, 1]))
        >>> metric.compute()
        tensor(0.6667)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        beta: float,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            threshold=threshold, multidim_average=multidim_average, ignore_index=ignore_index, validate_args=False,
            **kwargs,
        )
        if validate_args:
            _validate_beta(beta)
            _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        self.validate_args = validate_args
        self.beta = beta

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _fbeta_reduce(tp, fp, tn, fn, self.beta, average="binary", multidim_average=self.multidim_average)


class MulticlassFBetaScore(MulticlassStatScores):
    """Multiclass F-beta score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MulticlassFBetaScore
        >>> metric = MulticlassFBetaScore(beta=0.5, num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]))
        >>> metric.compute()
        tensor(0.7963)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        beta: float,
        num_classes: int,
        top_k: int = 1,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes,
            top_k=top_k,
            average=average,
            multidim_average=multidim_average,
            ignore_index=ignore_index,
            validate_args=False,
            **kwargs,
        )
        if validate_args:
            _validate_beta(beta)
            _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        self.validate_args = validate_args
        self.beta = beta

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _fbeta_reduce(tp, fp, tn, fn, self.beta, average=self.average, multidim_average=self.multidim_average)


class MultilabelFBetaScore(MultilabelStatScores):
    """Multilabel F-beta score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MultilabelFBetaScore
        >>> metric = MultilabelFBetaScore(beta=0.5, num_labels=3, device="cpu")
        >>> metric.update(torch.tensor([[1, 0, 1], [0, 1, 0], [1, 1, 0], [0, 0, 1]]),
        ...               torch.tensor([[1, 0, 0], [0, 1, 0], [1, 0, 0], [0, 1, 1]]))
        >>> metric.compute()
        tensor(0.6852)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        beta: float,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels,
            threshold=threshold,
            average=average,
            multidim_average=multidim_average,
            ignore_index=ignore_index,
            validate_args=False,
            **kwargs,
        )
        if validate_args:
            _validate_beta(beta)
            _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        self.validate_args = validate_args
        self.beta = beta

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _fbeta_reduce(
            tp, fp, tn, fn, self.beta, average=self.average, multidim_average=self.multidim_average, multilabel=True
        )


class BinaryF1Score(BinaryFBetaScore):
    """F1 (the harmonic mean of precision and recall) for binary tasks.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import BinaryF1Score
        >>> metric = BinaryF1Score(device="cpu")
        >>> metric.update(torch.tensor([0, 0, 1, 1, 0, 1]), torch.tensor([0, 1, 0, 1, 0, 1]))
        >>> metric.compute()
        tensor(0.6667)
    """

    def __init__(
        self,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            beta=1.0, threshold=threshold, multidim_average=multidim_average, ignore_index=ignore_index,
            validate_args=validate_args, **kwargs,
        )


class MulticlassF1Score(MulticlassFBetaScore):
    """Macro-averaged multiclass F1 by default.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MulticlassF1Score
        >>> metric = MulticlassF1Score(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([2, 1, 0, 1]), torch.tensor([2, 1, 0, 1]))
        >>> metric.compute()
        tensor(1.)
    """

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
        super().__init__(
            beta=1.0,
            num_classes=num_classes,
            top_k=top_k,
            average=average,
            multidim_average=multidim_average,
            ignore_index=ignore_index,
            validate_args=validate_args,
            **kwargs,
        )


class MultilabelF1Score(MultilabelFBetaScore):
    """Per-label F1, macro-averaged by default.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MultilabelF1Score
        >>> metric = MultilabelF1Score(num_labels=3, device="cpu")
        >>> metric.update(torch.tensor([[0.11, 0.58, 0.22], [0.84, 0.73, 0.33]]), torch.tensor([[0, 1, 0], [1, 0, 1]]))
        >>> metric.compute()
        tensor(0.5556)
    """

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
        super().__init__(
            beta=1.0,
            num_labels=num_labels,
            threshold=threshold,
            average=average,
            multidim_average=multidim_average,
            ignore_index=ignore_index,
            validate_args=validate_args,
            **kwargs,
        )


class FBetaScore:
    """Task-dispatch façade: ``__new__`` returns the task's F-beta score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import FBetaScore
        >>> metric = FBetaScore(task="multiclass", num_classes=3, beta=0.5, device="cpu")
        >>> metric.update(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]))
        >>> metric.compute()
        tensor(0.7500)
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        beta: float = 1.0,
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
        kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args})
        classes = tuple(functools.partial(c, beta) for c in (BinaryFBetaScore, MulticlassFBetaScore, MultilabelFBetaScore))
        return _task_metric(task, classes, threshold, num_classes, num_labels, average, top_k, kwargs)


class F1Score:
    """Task-dispatch façade: ``__new__`` returns the task's F1 score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import F1Score
        >>> metric = F1Score(task="multiclass", num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]))
        >>> metric.compute()
        tensor(0.7500)
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
        kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args})
        return _task_metric(task, (BinaryF1Score, MulticlassF1Score, MultilabelF1Score), threshold, num_classes,
                            num_labels, average, top_k, kwargs)
