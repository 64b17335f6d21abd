"""Confusion-matrix module metric, multiclass part
(port of ``metrics_tpu/classification/confusion_matrix.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _confusion_matrix_reduce,
    _multiclass_confusion_matrix_update,
)
from metrics_tpu_torch.functional.classification.stat_scores import (
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
)
from metrics_tpu_torch.metric import Metric, zero_state


class MulticlassConfusionMatrix(Metric):
    """(C, C) int32 confusion matrix, rows = true class.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MulticlassConfusionMatrix
        >>> metric = MulticlassConfusionMatrix(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([2, 1, 0, 1]), torch.tensor([2, 1, 0, 1]))
        >>> metric.compute()
        tensor([[1, 0, 0],
                [0, 2, 0],
                [0, 0, 1]], dtype=torch.int32)
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        ignore_index: Optional[int] = None,
        normalize: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.normalize = normalize
        self.validate_args = validate_args
        self.add_state(
            "confmat", zero_state((num_classes, num_classes), dtype=torch.int32, device=self.device), dist_reduce_fx="sum"
        )

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(preds, target, self.num_classes, "global", self.ignore_index)
        preds, target = _multiclass_stat_scores_format(preds, target, top_k=1)
        self.confmat = self.confmat + _multiclass_confusion_matrix_update(
            preds, target, self.num_classes, self.ignore_index
        )

    def compute(self) -> Tensor:
        return _confusion_matrix_reduce(self.confmat, self.normalize)
