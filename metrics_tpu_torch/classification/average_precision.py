"""Average-precision module metrics (port of ``metrics_tpu/classification/average_precision.py``)."""

from __future__ import annotations

from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from metrics_tpu_torch.functional.classification.auroc import _check_average
from metrics_tpu_torch.functional.classification.average_precision import (
    _binary_average_precision_compute,
    _multiclass_average_precision_compute,
    _multilabel_average_precision_compute,
)
from metrics_tpu_torch.functional.classification.precision_recall_curve import Thresholds
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.enums import ClassificationTask


class BinaryAveragePrecision(BinaryPrecisionRecallCurve):
    """Area under the precision-recall curve, as a step sum, for binary tasks."""

    higher_is_better = True

    def compute(self) -> Tensor:
        return _binary_average_precision_compute(self._curve_state(), self.thresholds)


class MulticlassAveragePrecision(MulticlassPrecisionRecallCurve):
    """One-vs-rest average precision for multiclass tasks."""

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
        return _multiclass_average_precision_compute(self._curve_state(), self.num_classes, self.average, self.thresholds)


class MultilabelAveragePrecision(MultilabelPrecisionRecallCurve):
    """Per-label average precision for multilabel tasks."""

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
        return _multilabel_average_precision_compute(
            self._curve_state(), self.num_labels, self.average, self.thresholds, self.ignore_index
        )


class AveragePrecision:
    """Task façade: the binary, multiclass or multilabel class for ``task``."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str_or_raise(task)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryAveragePrecision(**kwargs)
        if task == ClassificationTask.MULTICLASS:
            assert isinstance(num_classes, int)
            return MulticlassAveragePrecision(num_classes, average, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            assert isinstance(num_labels, int)
            return MultilabelAveragePrecision(num_labels, average, **kwargs)
        raise ValueError(f"Not handled value: {task}")
