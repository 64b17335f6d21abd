"""Calibration error module metrics: binary and multiclass, and the
``CalibrationError`` task façade (port of
``metrics_tpu/classification/calibration_error.py``).

The states are the per-bin sums, float32 ``acc_bin``, ``conf_bin`` and
``count_bin`` of length ``n_bins`` (scores of any float dtype are cast to
float32 first), summed over updates: binning commutes with accumulation, so
the value equals binning all the scores at once."""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.calibration_error import (
    _binary_calibration_error_arg_validation,
    _binary_calibration_error_tensor_validation,
    _binary_calibration_format,
    _ce_bucketize,
    _ce_compute_from_bins,
    _multiclass_calibration_error_arg_validation,
    _multiclass_calibration_error_tensor_validation,
    _multiclass_calibration_format,
)
from metrics_tpu_torch.metric import Metric, zero_state
from metrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel


class _CalibrationBins(Metric):
    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    acc_bin: Tensor
    conf_bin: Tensor
    count_bin: Tensor

    def _create_state(self, n_bins: int, norm: str, ignore_index: Optional[int], validate_args: bool) -> None:
        self.n_bins = n_bins
        self.norm = norm
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        for name in ("acc_bin", "conf_bin", "count_bin"):
            self.add_state(name, zero_state((n_bins,), torch.float32, self.device), dist_reduce_fx="sum")

    def _update_bins(self, confidences: Tensor, accuracies: Tensor, weights: Tensor) -> None:
        acc, conf, count = _ce_bucketize(confidences, accuracies, self.n_bins, weights=weights)
        self.acc_bin = self.acc_bin + acc
        self.conf_bin = self.conf_bin + conf
        self.count_bin = self.count_bin + count

    def compute(self) -> Tensor:
        return _ce_compute_from_bins(self.acc_bin, self.conf_bin, self.count_bin, self.norm)


class BinaryCalibrationError(_CalibrationBins):
    """Expected calibration error of binary scores.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import BinaryCalibrationError
        >>> metric = BinaryCalibrationError(n_bins=2, device="cpu")
        >>> metric.update(torch.tensor([0.9, 0.1, 0.8, 0.3]), torch.tensor([1, 0, 1, 1]))
        >>> round(float(metric.compute()), 4)
        0.225
    """

    def __init__(
        self,
        n_bins: int = 15,
        norm: str = "l1",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)
        self._create_state(n_bins, norm, ignore_index, validate_args)

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _binary_calibration_error_tensor_validation(preds, target, self.ignore_index)
        self._update_bins(*_binary_calibration_format(preds, target, self.ignore_index, torch.float32))


class MulticlassCalibrationError(_CalibrationBins):
    """Expected calibration error of the top-1 multiclass scores.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import MulticlassCalibrationError
        >>> metric = MulticlassCalibrationError(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([[0.7, 0.2, 0.1], [0.2, 0.6, 0.2], [0.1, 0.2, 0.7], [0.3, 0.4, 0.3]]),
        ...               torch.tensor([0, 1, 2, 1]))
        >>> metric.compute()
        tensor(0.4000)
    """

    def __init__(
        self,
        num_classes: int,
        n_bins: int = 15,
        norm: str = "l1",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_calibration_error_arg_validation(num_classes, n_bins, norm, ignore_index)
        self.num_classes = num_classes
        self._create_state(n_bins, norm, ignore_index, validate_args)

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_calibration_error_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        self._update_bins(
            *_multiclass_calibration_format(preds, target, self.num_classes, self.ignore_index, torch.float32)
        )


class CalibrationError:
    """Task-dispatch façade: ``__new__`` returns the task's calibration error.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.classification import CalibrationError
        >>> metric = CalibrationError(task="multiclass", num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([[0.7, 0.2, 0.1], [0.2, 0.6, 0.2], [0.1, 0.2, 0.7], [0.3, 0.4, 0.3]]),
        ...               torch.tensor([0, 1, 2, 1]))
        >>> metric.compute()
        tensor(0.4000)
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        n_bins: int = 15,
        norm: str = "l1",
        num_classes: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTaskNoMultilabel.from_str_or_raise(task)
        kwargs.update({"n_bins": n_bins, "norm": norm, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoMultilabel.BINARY:
            return BinaryCalibrationError(**kwargs)
        if task == ClassificationTaskNoMultilabel.MULTICLASS:
            assert isinstance(num_classes, int)
            return MulticlassCalibrationError(num_classes, **kwargs)
        raise ValueError(f"Not handled value: {task}")
