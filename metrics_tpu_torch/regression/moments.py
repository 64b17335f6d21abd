"""Moment-streaming regression modules: Pearson, concordance, explained
variance and R² (port of ``metrics_tpu/regression/moments.py``).

Every state is a fixed-shape float32 tensor whatever the input dtype (ROADMAP
C.8), and every update adds onto the states without reading a value on the
host, so the serving engine fuses these metrics into CUDA-graph replays.
Pearson's and concordance's Welford states reduce with ``dist_reduce_fx=None``:
a sync stacks each replica's state along a new leading axis, and compute
merges the stack with the parallel-variance rule (``_final_aggregation``).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.regression.moments import (
    _concordance_corrcoef_compute,
    _explained_variance_compute,
    _explained_variance_update,
    _pearson_corrcoef_compute,
    _pearson_corrcoef_update,
    _r2_score_compute,
    _r2_score_update,
)
from metrics_tpu_torch.metric import Metric, zero_state
from metrics_tpu_torch.regression.basic import _ErrorSum

_ALLOWED_MULTIOUTPUT = ("raw_values", "uniform_average", "variance_weighted")


def _final_aggregation(
    means_x: Tensor, means_y: Tensor, vars_x: Tensor, vars_y: Tensor, corrs_xy: Tensor, nbs: Tensor
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Merge Welford states stacked along their first axis (one entry a
    replica), pairwise in stack order."""
    if means_x.ndim == 0 or means_x.shape[0] == 1:
        first = [t[0] if t.ndim else t for t in (means_x, means_y, vars_x, vars_y, corrs_xy, nbs)]
        return tuple(first)  # type: ignore[return-value]
    mx1, my1, vx1, vy1, cxy1, n1 = means_x[0], means_y[0], vars_x[0], vars_y[0], corrs_xy[0], nbs[0]
    for i in range(1, means_x.shape[0]):
        mx2, my2, vx2, vy2, cxy2, n2 = means_x[i], means_y[i], vars_x[i], vars_y[i], corrs_xy[i], nbs[i]
        nb = n1 + n2
        mean_x = (n1 * mx1 + n2 * mx2) / nb
        mean_y = (n1 * my1 + n2 * my2) / nb

        element_x1 = (n1 + 1) * mean_x - n1 * mx1
        vx1 = vx1 + (element_x1 - mx1) * (element_x1 - mean_x) - (element_x1 - mean_x) ** 2
        element_x2 = (n2 + 1) * mean_x - n2 * mx2
        vx2 = vx2 + (element_x2 - mx2) * (element_x2 - mean_x) - (element_x2 - mean_x) ** 2
        var_x = vx1 + vx2

        element_y1 = (n1 + 1) * mean_y - n1 * my1
        vy1 = vy1 + (element_y1 - my1) * (element_y1 - mean_y) - (element_y1 - mean_y) ** 2
        element_y2 = (n2 + 1) * mean_y - n2 * my2
        vy2 = vy2 + (element_y2 - my2) * (element_y2 - mean_y) - (element_y2 - mean_y) ** 2
        var_y = vy1 + vy2

        cxy1 = cxy1 + (element_x1 - mx1) * (element_y1 - mean_y) - (element_x1 - mean_x) * (element_y1 - mean_y)
        cxy2 = cxy2 + (element_x2 - mx2) * (element_y2 - mean_y) - (element_x2 - mean_x) * (element_y2 - mean_y)
        corr_xy = cxy1 + cxy2

        mx1, my1, vx1, vy1, cxy1, n1 = mean_x, mean_y, var_x, var_y, corr_xy, nb
    return mx1, my1, vx1, vy1, cxy1, n1


class _PearsonBase(Metric):
    """The Welford states that Pearson and concordance share."""

    is_differentiable = True
    full_state_update = True

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(num_outputs, int) and num_outputs > 0):
            raise ValueError("Expected argument `num_outputs` to be an int larger than 0")
        self.num_outputs = num_outputs
        shape = (num_outputs,) if num_outputs > 1 else ()
        for name in ("mean_x", "mean_y", "var_x", "var_y", "corr_xy"):
            self.add_state(name, zero_state(shape, torch.float32, device=self.device), dist_reduce_fx=None)
        self.add_state("n_total", zero_state((), torch.float32, device=self.device), dist_reduce_fx=None)

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total = _pearson_corrcoef_update(
            preds, target, self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total,
            self.num_outputs,
        )

    def _aggregate(self) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
        if self.mean_x.ndim > (1 if self.num_outputs > 1 else 0):
            # synced: stacked over replicas, merged by the parallel rule
            return _final_aggregation(self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total)
        return self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total


class PearsonCorrCoef(_PearsonBase):
    """Pearson Corr Coef.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PearsonCorrCoef
        >>> metric = PearsonCorrCoef(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(metric.compute()), 4)
        0.9849
    """

    higher_is_better = None

    def compute(self) -> Tensor:
        _, _, var_x, var_y, corr_xy, n_total = self._aggregate()
        return _pearson_corrcoef_compute(var_x, var_y, corr_xy, n_total)


class ConcordanceCorrCoef(_PearsonBase):
    """Concordance Corr Coef.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ConcordanceCorrCoef
        >>> metric = ConcordanceCorrCoef(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> metric.compute()
        tensor(0.9777)
    """

    higher_is_better = None

    def compute(self) -> Tensor:
        return _concordance_corrcoef_compute(*self._aggregate())


def _check_multioutput(multioutput: str) -> str:
    if multioutput not in _ALLOWED_MULTIOUTPUT:
        raise ValueError(
            f"Invalid input to argument `multioutput`. Choose one of the following: {_ALLOWED_MULTIOUTPUT}"
        )
    return multioutput


class _SumStates(_ErrorSum):
    """Float32 sum states, each update adding an increment cast to the state's
    dtype (``_ErrorSum._accumulate``)."""

    higher_is_better = True

    def _add_sums(self, shape: Any, *names: str) -> None:
        for name in names:
            self.add_state(name, zero_state(shape, torch.float32, device=self.device), dist_reduce_fx="sum")


class ExplainedVariance(_SumStates):
    """Explained Variance.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ExplainedVariance
        >>> metric = ExplainedVariance(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> metric.compute()
        tensor(0.9572)
    """

    def __init__(self, multioutput: str = "uniform_average", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.multioutput = _check_multioutput(multioutput)
        self._add_sums((), "sum_error", "sum_squared_error", "sum_target", "sum_squared_target", "num_obs")

    def update(self, preds: Tensor, target: Tensor) -> None:
        num_obs, sum_error, sum_squared_error, sum_target, sum_squared_target = _explained_variance_update(
            preds, target
        )
        self._accumulate(
            num_obs=float(num_obs),
            sum_error=sum_error,
            sum_squared_error=sum_squared_error,
            sum_target=sum_target,
            sum_squared_target=sum_squared_target,
        )

    def compute(self) -> Tensor:
        return _explained_variance_compute(
            self.num_obs, self.sum_error, self.sum_squared_error, self.sum_target, self.sum_squared_target,
            self.multioutput,
        )


class R2Score(_SumStates):
    """R2 Score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import R2Score
        >>> metric = R2Score(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> metric.compute()
        tensor(0.9486)
    """

    def __init__(self, num_outputs: int = 1, adjusted: int = 0, multioutput: str = "uniform_average",
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        if adjusted < 0 or not isinstance(adjusted, int):
            raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
        self.adjusted = adjusted
        self.multioutput = _check_multioutput(multioutput)
        self._add_sums((num_outputs,) if num_outputs > 1 else (), "sum_squared_error", "sum_error", "residual")
        self._add_sums((), "total")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_obs, sum_obs, residual, num_obs = _r2_score_update(preds, target)
        self._accumulate(sum_squared_error=sum_squared_obs, sum_error=sum_obs, residual=residual,
                         total=float(num_obs))

    def compute(self) -> Tensor:
        return _r2_score_compute(
            self.sum_squared_error, self.sum_error, self.residual, self.total, self.adjusted, self.multioutput
        )
