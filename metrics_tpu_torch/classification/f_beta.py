"""F-beta / F1 module metrics, multiclass part (port of ``metrics_tpu/classification/f_beta.py``)."""

from __future__ import annotations

from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.stat_scores import MulticlassStatScores
from metrics_tpu_torch.functional.classification.f_beta import _fbeta_reduce, _validate_beta
from metrics_tpu_torch.functional.classification.stat_scores import _multiclass_stat_scores_arg_validation


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
