"""The other regression modules: cosine similarity, KL divergence, Tweedie
deviance, Spearman's and Kendall's rank correlations (port of
``metrics_tpu/regression/misc.py``).

``TweedieDevianceScore`` and ``KLDivergence`` with a "mean" or "sum"
reduction keep float32 sum states, so the serving engine fuses them.
``CosineSimilarity``, ``KLDivergence(reduction=None)`` and the two rank
correlations keep list states ("cat"); the rank correlations compute from
the whole sample (``_host_compute``), eagerly on the states' own device.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.regression.misc import (
    _cosine_similarity_compute,
    _cosine_similarity_update,
    _floating_or_raise,
    _kendall_arg_validation,
    _kld_update,
    _spearman_corrcoef_compute,
    _tweedie_deviance_score_compute,
    _tweedie_deviance_score_update,
    kendall_rank_corrcoef,
)
from metrics_tpu_torch.metric import Metric, zero_state
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import dim_zero_cat


class CosineSimilarity(Metric):
    """Cosine Similarity.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CosineSimilarity
        >>> metric = CosineSimilarity(device="cpu")
        >>> metric.update(torch.tensor([[3.0, 4.0], [1.0, 0.0]]), torch.tensor([[3.0, 4.0], [0.0, 1.0]]))
        >>> metric.compute()
        tensor(1.)
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, reduction: str = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        allowed_reduction = ("sum", "mean", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _cosine_similarity_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        return _cosine_similarity_compute(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.reduction)


class KLDivergence(Metric):
    """KL Divergence.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import KLDivergence
        >>> metric = KLDivergence(device="cpu")
        >>> metric.update(torch.tensor([[0.36, 0.48, 0.16]]), torch.tensor([[1 / 3, 1 / 3, 1 / 3]]))
        >>> round(float(metric.compute()), 4)
        0.0853
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, log_prob: bool = False, reduction: Optional[str] = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(log_prob, bool):
            raise TypeError(f"Expected argument `log_prob` to be bool but got {log_prob}")
        self.log_prob = log_prob
        allowed_reduction = ("mean", "sum", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction

        if self.reduction in ("mean", "sum"):
            self.add_state("measures", zero_state((), torch.float32, device=self.device), dist_reduce_fx="sum")
        else:
            self.add_state("measures", [], dist_reduce_fx="cat")
        self.add_state("total", zero_state((), torch.float32, device=self.device), dist_reduce_fx="sum")

    def update(self, p: Tensor, q: Tensor) -> None:
        measures, total = _kld_update(p, q, self.log_prob)
        if self.reduction is None or self.reduction == "none":
            self.measures.append(measures)
        else:
            self.measures = self.measures + torch.sum(measures).to(torch.float32)
        self.total = self.total + total

    def compute(self) -> Tensor:
        measures = dim_zero_cat(self.measures) if isinstance(self.measures, list) else self.measures
        if self.reduction == "mean":
            return measures / self.total
        return measures


class TweedieDevianceScore(Metric):
    """Tweedie Deviance Score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import TweedieDevianceScore
        >>> metric = TweedieDevianceScore(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> metric.compute()
        tensor(0.3750)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, power: float = 0.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if 0 < power < 1:
            raise ValueError(f"Deviance Score is not defined for power={power}.")
        self.power = power
        self.add_state("sum_deviance_score", zero_state((), torch.float32, device=self.device), dist_reduce_fx="sum")
        self.add_state("num_observations", zero_state((), torch.float32, device=self.device), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, target, self.power)
        self.sum_deviance_score = self.sum_deviance_score + sum_deviance_score
        self.num_observations = self.num_observations + num_observations

    def compute(self) -> Tensor:
        return _tweedie_deviance_score_compute(self.sum_deviance_score, self.num_observations)


class _RankCorrelation(Metric):
    """List states of float32 scores and targets; compute runs on the whole
    sample (``_host_compute``: eagerly, on the states' own device)."""

    is_differentiable = False
    full_state_update = False
    _host_compute = True

    def _add_sample_states(self) -> None:
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def _append(self, preds: Tensor, target: Tensor) -> None:
        self.preds.append(preds.to(torch.float32))
        self.target.append(target.to(torch.float32))

    def _sample(self) -> Tuple[Tensor, Tensor]:
        return dim_zero_cat(self.preds), dim_zero_cat(self.target)


class SpearmanCorrCoef(_RankCorrelation):
    """Spearman Corr Coef.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SpearmanCorrCoef
        >>> metric = SpearmanCorrCoef(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(metric.compute()), 4)
        1.0
    """

    higher_is_better = True

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(num_outputs, int) and num_outputs > 0):
            raise ValueError("Expected argument `num_outputs` to be an int larger than 0")
        self.num_outputs = num_outputs
        self._add_sample_states()

    def update(self, preds: Tensor, target: Tensor) -> None:
        _check_same_shape(preds, target)
        _floating_or_raise(preds, target)
        self._append(preds, target)

    def compute(self) -> Tensor:
        return _spearman_corrcoef_compute(*self._sample())


class KendallRankCorrCoef(_RankCorrelation):
    """Kendall Rank Corr Coef; with ``t_test=True`` compute gives ``(tau, p_value)``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import KendallRankCorrCoef
        >>> metric = KendallRankCorrCoef(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> float(metric.compute())
        1.0
    """

    higher_is_better = None
    full_state_update = True

    def __init__(
        self,
        variant: str = "b",
        t_test: bool = False,
        alternative: Optional[str] = "two-sided",
        num_outputs: int = 1,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _kendall_arg_validation(variant, t_test)
        self.variant = variant
        self.t_test = t_test
        self.alternative = alternative
        self.num_outputs = num_outputs
        self._add_sample_states()

    def update(self, preds: Tensor, target: Tensor) -> None:
        _check_same_shape(preds, target)
        self._append(torch.as_tensor(preds), torch.as_tensor(target))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        return kendall_rank_corrcoef(*self._sample(), self.variant, self.t_test, self.alternative)
