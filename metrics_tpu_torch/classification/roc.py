"""ROC module metrics (port of ``metrics_tpu/classification/roc.py``): the
precision-recall curve classes' states, with the ROC compute."""

from __future__ import annotations

from typing import Any, Optional

from metrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from metrics_tpu_torch.functional.classification.precision_recall_curve import Thresholds
from metrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.enums import ClassificationTask


class BinaryROC(BinaryPrecisionRecallCurve):
    """ROC curve (fpr, tpr, thresholds) for binary tasks."""

    def compute(self):
        return _binary_roc_compute(self._curve_state(), self.thresholds)


class MulticlassROC(MulticlassPrecisionRecallCurve):
    """One-vs-rest ROC curves for multiclass tasks."""

    def compute(self):
        return _multiclass_roc_compute(self._curve_state(), self.num_classes, self.thresholds)


class MultilabelROC(MultilabelPrecisionRecallCurve):
    """Per-label ROC curves for multilabel tasks."""

    def compute(self):
        return _multilabel_roc_compute(self._curve_state(), self.num_labels, self.thresholds, self.ignore_index)


class ROC:
    """Task façade: the binary, multiclass or multilabel class for ``task``."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str_or_raise(task)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryROC(**kwargs)
        if task == ClassificationTask.MULTICLASS:
            assert isinstance(num_classes, int)
            return MulticlassROC(num_classes, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            assert isinstance(num_labels, int)
            return MultilabelROC(num_labels, **kwargs)
        raise ValueError(f"Not handled value: {task}")
