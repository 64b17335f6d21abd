"""AUROC module metrics (port of ``metrics_tpu/classification/auroc.py``)."""

from __future__ import annotations

from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from metrics_tpu_torch.functional.classification.auroc import (
    _binary_auroc_compute,
    _check_average,
    _multiclass_auroc_compute,
    _multilabel_auroc_compute,
)
from metrics_tpu_torch.functional.classification.precision_recall_curve import Thresholds
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.enums import ClassificationTask


class BinaryAUROC(BinaryPrecisionRecallCurve):
    """Area under the ROC curve, exact (``thresholds=None``) or binned; partial
    up to ``max_fpr`` with the McClish correction.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import BinaryAUROC
        >>> metric = BinaryAUROC(thresholds=200, device="cpu")
        >>> metric.update(torch.tensor([0.1, 0.6, 0.8, 0.4]), torch.tensor([0, 1, 1, 0]))
        >>> metric.compute()
        tensor(1.)
    """

    higher_is_better = True

    def __init__(
        self,
        max_fpr: Optional[float] = None,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args, **kwargs)
        if validate_args and max_fpr is not None and not (isinstance(max_fpr, float) and 0 < max_fpr <= 1):
            raise ValueError(f"Arguments `max_fpr` should be a float in range (0, 1], but got: {max_fpr}")
        self.max_fpr = max_fpr

    def compute(self) -> Tensor:
        return _binary_auroc_compute(self._curve_state(), self.thresholds, self.max_fpr)


class MulticlassAUROC(MulticlassPrecisionRecallCurve):
    """One-vs-rest AUROC for multiclass tasks, averaged (macro, weighted) or per class."""

    higher_is_better = True

    def __init__(
        self,
        num_classes: int,
        average: Optional[str] = "macro",
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index,
                         validate_args=validate_args, **kwargs)
        if validate_args:
            _check_average(average, ("macro", "weighted", "none", None))
        self.average = average

    def compute(self) -> Tensor:
        return _multiclass_auroc_compute(self._curve_state(), self.num_classes, self.average, self.thresholds)


class MultilabelAUROC(MultilabelPrecisionRecallCurve):
    """Per-label AUROC for multilabel tasks, averaged (micro, macro, weighted) or per label."""

    higher_is_better = True

    def __init__(
        self,
        num_labels: int,
        average: Optional[str] = "macro",
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index,
                         validate_args=validate_args, **kwargs)
        if validate_args:
            _check_average(average, ("micro", "macro", "weighted", "none", None))
        self.average = average

    def compute(self) -> Tensor:
        return _multilabel_auroc_compute(
            self._curve_state(), self.num_labels, self.average, self.thresholds, self.ignore_index
        )


class AUROC:
    """Task façade: the binary, multiclass or multilabel class for ``task``."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "macro",
        max_fpr: Optional[float] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str_or_raise(task)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryAUROC(max_fpr, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            assert isinstance(num_classes, int)
            return MulticlassAUROC(num_classes, average, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            assert isinstance(num_labels, int)
            return MultilabelAUROC(num_labels, average, **kwargs)
        raise ValueError(f"Not handled value: {task}")
