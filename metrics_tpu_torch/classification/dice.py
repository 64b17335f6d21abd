"""Dice module metric, with the legacy ``average`` / ``mdmc_average`` API (port
of ``metrics_tpu/classification/dice.py``).

Global modes keep int32 tp/fp/tn/fn summed over updates (scalars for micro,
``(num_classes,)`` otherwise); ``mdmc_average="samplewise"`` and
``average="samples"`` keep list states of per-sample counts."""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.dice import (
    _dice_arg_validation,
    _dice_compute,
    _dice_stat_scores_update,
)
from metrics_tpu_torch.metric import Metric, zero_state
from metrics_tpu_torch.utils.data import dim_zero_cat

_COUNTS = ("tp", "fp", "tn", "fn")


class Dice(Metric):
    """Dice coefficient.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Dice
        >>> metric = Dice(device="cpu")
        >>> metric.update(torch.tensor([0, 1, 1, 0]), torch.tensor([0, 1, 0, 0]))
        >>> metric.compute()
        tensor(0.7500)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        zero_division: float = 0.0,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: Optional[str] = "micro",
        mdmc_average: Optional[str] = "global",
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _dice_arg_validation(average, mdmc_average, num_classes, ignore_index)
        self.zero_division = zero_division
        self.num_classes = num_classes
        self.threshold = threshold
        self.average = average
        self.mdmc_average = mdmc_average
        self.ignore_index = ignore_index
        self.top_k = top_k
        self.multiclass = multiclass
        self.reduce = "macro" if average in ("weighted", "none", None) else average

        self._list_states = mdmc_average == "samplewise" or self.reduce == "samples"
        for name in _COUNTS:
            if self._list_states:
                self.add_state(name, [], dist_reduce_fx="cat")
            else:
                shape = () if self.reduce == "micro" else (num_classes,)
                self.add_state(name, zero_state(shape, torch.int32, self.device), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        counts = _dice_stat_scores_update(
            preds, target, reduce=self.reduce, mdmc_reduce=self.mdmc_average, num_classes=self.num_classes,
            top_k=self.top_k, threshold=self.threshold, multiclass=self.multiclass, ignore_index=self.ignore_index,
        )
        for name, count in zip(_COUNTS, counts):
            if self._list_states:
                getattr(self, name).append(torch.atleast_1d(count))
            else:
                setattr(self, name, getattr(self, name) + count)

    def compute(self) -> Tensor:
        tp, fp, fn = (dim_zero_cat(s) if self._list_states else s for s in (self.tp, self.fp, self.fn))
        return _dice_compute(tp, fp, fn, self.average, self.mdmc_average, self.zero_division)
