"""Nominal association module metrics (port of ``metrics_tpu/nominal/stats.py``):
an int32 ``(num_classes, num_classes)`` contingency table summed over updates
(one ``csrc/pair_count.cu`` launch an update on the card), and each statistic's
compute. The compute drops empty rows and columns, a data-dependent shape, so
it runs eagerly (``_host_compute``)."""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.nominal.stats import (
    _cramers_v_compute,
    _format_nominal,
    _pearsons_contingency_coefficient_compute,
    _theils_u_compute,
    _tschuprows_t_compute,
)
from metrics_tpu_torch.functional.nominal.utils import _joint_confusion_matrix, _nominal_input_validation
from metrics_tpu_torch.metric import Metric, zero_state


class _NominalBase(Metric):
    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    _host_compute = True  # empty rows and columns are dropped: a data-dependent shape

    confmat: Tensor

    def __init__(
        self,
        num_classes: int,
        nan_strategy: str = "replace",
        nan_replace_value: Optional[float] = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(num_classes, int) or num_classes < 1:
            raise ValueError("Expected argument `num_classes` to be a positive integer")
        self.num_classes = num_classes
        _nominal_input_validation(nan_strategy, nan_replace_value)
        self.nan_strategy = nan_strategy
        self.nan_replace_value = nan_replace_value
        self.add_state("confmat", zero_state((num_classes, num_classes), torch.int32, self.device), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _format_nominal(preds, target, self.nan_strategy, self.nan_replace_value)
        self.confmat = self.confmat + _joint_confusion_matrix(preds, target, self.num_classes, self.num_classes)


class CramersV(_NominalBase):
    """Cramér's V.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CramersV
        >>> metric = CramersV(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 1, 2, 1, 0, 2, 1]), torch.tensor([0, 1, 2, 1, 0, 2, 2]))
        >>> round(float(metric.compute()), 4)
        0.7638
    """

    def __init__(self, num_classes: int, bias_correction: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes, **kwargs)
        self.bias_correction = bias_correction

    def compute(self) -> Tensor:
        return _cramers_v_compute(self.confmat, self.bias_correction)


class PearsonsContingencyCoefficient(_NominalBase):
    """Pearson's contingency coefficient.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PearsonsContingencyCoefficient
        >>> metric = PearsonsContingencyCoefficient(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 1, 2, 1, 0, 2, 1]), torch.tensor([0, 1, 2, 1, 0, 2, 2]))
        >>> round(float(metric.compute()), 4)
        0.7687
    """

    def compute(self) -> Tensor:
        return _pearsons_contingency_coefficient_compute(self.confmat)


class TschuprowsT(_NominalBase):
    """Tschuprow's T.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import TschuprowsT
        >>> metric = TschuprowsT(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 1, 2, 1, 0, 2, 1]), torch.tensor([0, 1, 2, 1, 0, 2, 2]))
        >>> round(float(metric.compute()), 4)
        0.7638
    """

    def __init__(self, num_classes: int, bias_correction: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes, **kwargs)
        self.bias_correction = bias_correction

    def compute(self) -> Tensor:
        return _tschuprows_t_compute(self.confmat, self.bias_correction)


class TheilsU(_NominalBase):
    """Theil's U.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import TheilsU
        >>> metric = TheilsU(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 1, 2, 1, 0, 2, 1]), torch.tensor([0, 1, 2, 1, 0, 2, 2]))
        >>> round(float(metric.compute()), 4)
        0.7472
    """

    def compute(self) -> Tensor:
        return _theils_u_compute(self.confmat)
