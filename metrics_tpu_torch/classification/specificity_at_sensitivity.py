"""Specificity-at-sensitivity module metrics (port of
``metrics_tpu/classification/specificity_at_sensitivity.py``): the
precision-recall curve classes' states, with the ROC-based selection."""

from __future__ import annotations

from typing import Any, Optional, Tuple

from torch import Tensor

from metrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from metrics_tpu_torch.functional.classification.precision_recall_curve import Thresholds
from metrics_tpu_torch.functional.classification.specificity_at_sensitivity import (
    _binary_specificity_at_sensitivity_arg_validation,
    _binary_specificity_at_sensitivity_compute,
    _multiclass_specificity_at_sensitivity_arg_validation,
    _multiclass_specificity_at_sensitivity_compute,
    _multilabel_specificity_at_sensitivity_arg_validation,
    _multilabel_specificity_at_sensitivity_compute,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.enums import ClassificationTask


class BinarySpecificityAtSensitivity(BinaryPrecisionRecallCurve):
    """The highest specificity with sensitivity >= ``min_sensitivity``, and its threshold."""

    higher_is_better = True

    def __init__(
        self,
        min_sensitivity: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _binary_specificity_at_sensitivity_arg_validation(min_sensitivity, thresholds, ignore_index)
        self.validate_args = validate_args
        self.min_sensitivity = min_sensitivity

    def compute(self) -> Tuple[Tensor, Tensor]:
        return _binary_specificity_at_sensitivity_compute(self._curve_state(), self.thresholds, self.min_sensitivity)


class MulticlassSpecificityAtSensitivity(MulticlassPrecisionRecallCurve):
    """Per class: the highest specificity with sensitivity >= ``min_sensitivity``, and its threshold."""

    higher_is_better = True

    def __init__(
        self,
        num_classes: int,
        min_sensitivity: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index,
                         validate_args=False, **kwargs)
        if validate_args:
            _multiclass_specificity_at_sensitivity_arg_validation(num_classes, min_sensitivity, thresholds, ignore_index)
        self.validate_args = validate_args
        self.min_sensitivity = min_sensitivity

    def compute(self) -> Tuple[Tensor, Tensor]:
        return _multiclass_specificity_at_sensitivity_compute(
            self._curve_state(), self.num_classes, self.thresholds, self.min_sensitivity
        )


class MultilabelSpecificityAtSensitivity(MultilabelPrecisionRecallCurve):
    """Per label: the highest specificity with sensitivity >= ``min_sensitivity``, and its threshold."""

    higher_is_better = True

    def __init__(
        self,
        num_labels: int,
        min_sensitivity: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index,
                         validate_args=False, **kwargs)
        if validate_args:
            _multilabel_specificity_at_sensitivity_arg_validation(num_labels, min_sensitivity, thresholds, ignore_index)
        self.validate_args = validate_args
        self.min_sensitivity = min_sensitivity

    def compute(self) -> Tuple[Tensor, Tensor]:
        return _multilabel_specificity_at_sensitivity_compute(
            self._curve_state(), self.num_labels, self.thresholds, self.ignore_index, self.min_sensitivity
        )


class SpecificityAtSensitivity:
    """Task façade: the binary, multiclass or multilabel class for ``task``."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        min_sensitivity: float,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str_or_raise(task)
        if task == ClassificationTask.BINARY:
            return BinarySpecificityAtSensitivity(min_sensitivity, thresholds, ignore_index, validate_args, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            assert isinstance(num_classes, int)
            return MulticlassSpecificityAtSensitivity(
                num_classes, min_sensitivity, thresholds, ignore_index, validate_args, **kwargs
            )
        if task == ClassificationTask.MULTILABEL:
            assert isinstance(num_labels, int)
            return MultilabelSpecificityAtSensitivity(
                num_labels, min_sensitivity, thresholds, ignore_index, validate_args, **kwargs
            )
        raise ValueError(f"Not handled value: {task}")
