"""Permutation invariant training (port of ``metrics_tpu/functional/audio/pit.py``).

The metric matrix ``[batch, target_spk, pred_spk]`` comes from one
``metric_func`` call a speaker pair. The best permutation is an exhaustive
search over the ``spk!`` permutation table on the matrix's device (argmax and
argmin take the first index on ties, as in JAX), or scipy's
``linear_sum_assignment`` on the host, which the automatic rule picks for
``spk_num >= 3`` outside a trace (:func:`metrics_tpu_torch.utils.checks.traced`,
a CUDA-graph capture, ``torch.compile``).
"""

from __future__ import annotations

import functools
from itertools import permutations
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _value_check_possible
from metrics_tpu_torch.utils.imports import _SCIPY_AVAILABLE
from metrics_tpu_torch.utils.prints import rank_zero_warn

# permutation tables by speaker count (host constants)
_ps_dict: Dict[int, np.ndarray] = {}


def _perm_table(spk_num: int) -> np.ndarray:
    """All permutations as an int32 array of shape [perm_num, spk_num]."""
    if spk_num not in _ps_dict:
        _ps_dict[spk_num] = np.asarray(list(permutations(range(spk_num))), dtype=np.int32)
    return _ps_dict[spk_num]


@functools.lru_cache(maxsize=16)
def _perm_table_on(spk_num: int, device: torch.device) -> Tensor:
    """The permutation table on ``device``, copied once."""
    return torch.from_numpy(_perm_table(spk_num)).to(device)


def _find_best_perm_by_exhaustive_method(metric_mtx: Tensor, eval_func: str) -> Tuple[Tensor, Tensor]:
    """Exhaustive assignment over ``metric_mtx`` ``[batch, spk, spk]`` (entry
    [b, t, p] scores target t against pred p)."""
    spk_num = metric_mtx.shape[-1]
    ps = _perm_table_on(spk_num, metric_mtx.device)  # [perm_num, spk]
    # a permutation's score: the mean over target t of mtx[b, t, ps[k, t]]
    per_perm = torch.mean(metric_mtx[:, torch.arange(spk_num, device=metric_mtx.device)[None, :], ps.long()], dim=-1)
    if eval_func == "max":
        best_idx, best_metric = torch.argmax(per_perm, dim=-1), torch.amax(per_perm, dim=-1)
    else:
        best_idx, best_metric = torch.argmin(per_perm, dim=-1), torch.amin(per_perm, dim=-1)
    return best_metric, ps[best_idx]


def _find_best_perm_by_linear_sum_assignment(metric_mtx: Tensor, eval_func: str) -> Tuple[Tensor, Tensor]:
    """scipy's Hungarian solver on the host, one matrix a sample."""
    from scipy.optimize import linear_sum_assignment

    mmtx = metric_mtx.detach().cpu().numpy()
    best_perm = torch.from_numpy(
        np.stack([linear_sum_assignment(pwm, eval_func == "max")[1] for pwm in mmtx]).astype(np.int32)
    ).to(metric_mtx.device)
    best_metric = torch.mean(torch.take_along_dim(metric_mtx, best_perm[:, :, None].long(), dim=2), dim=(-1, -2))
    return best_metric, best_perm


def permutation_invariant_training(
    preds: Tensor,
    target: Tensor,
    metric_func: Callable,
    eval_func: str = "max",
    use_linear_sum_assignment: Optional[bool] = None,
    **kwargs: Any,
) -> Tuple[Tensor, Tensor]:
    """PIT: the best metric value over speaker permutations, and that permutation (int32).

    Args:
        preds: ``(batch, spk, ...)`` estimated signals
        target: ``(batch, spk, ...)`` reference signals
        metric_func: batched pairwise metric ``(preds, target, **kwargs) -> (batch,)``
        eval_func: 'max' (higher is better) or 'min'
        use_linear_sum_assignment: ``None`` picks scipy's Hungarian solver for
            ``spk_num >= 3`` when scipy is there and no trace runs, else the
            exhaustive search; ``True`` forces the solver (an error without
            scipy or inside a trace); ``False`` forces the ``spk!`` search.
        kwargs: passed on to ``metric_func``

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional.audio import scale_invariant_signal_distortion_ratio
        >>> preds = torch.tensor([[[-0.0579, 0.3560, -0.9604], [-0.1719, 0.3205, 0.2951]]])
        >>> target = torch.tensor([[[1.0958, -0.1648, 0.5228], [-0.4100, 1.1942, -0.5103]]])
        >>> best_metric, best_perm = permutation_invariant_training(
        ...     preds, target, scale_invariant_signal_distortion_ratio, 'max')
        >>> best_perm.tolist()
        [[0, 1]]
    """
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    if preds.shape[0:2] != target.shape[0:2]:
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape at the batch and speaker dimensions"
        )
    if eval_func not in ["max", "min"]:
        raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
    if target.ndim < 2:
        raise ValueError(f"Inputs must be of shape [batch, spk, ...], got {target.shape} and {preds.shape} instead")

    spk_num = target.shape[1]
    # [batch, target_spk, pred_spk]: one metric_func call a speaker pair
    metric_mtx = torch.stack(
        [torch.stack([torch.as_tensor(metric_func(preds[:, p, ...], target[:, t, ...], **kwargs))
                      for p in range(spk_num)], dim=-1) for t in range(spk_num)],
        dim=-2,
    ).reshape(target.shape[0], spk_num, spk_num)

    in_trace = not _value_check_possible(metric_mtx)
    if use_linear_sum_assignment is None:
        use_linear_sum_assignment = spk_num >= 3 and _SCIPY_AVAILABLE and not in_trace
        if spk_num >= 3 and not use_linear_sum_assignment:
            rank_zero_warn(
                f"For {spk_num} speakers the exhaustive search enumerates {spk_num}! permutations; the scipy"
                " Hungarian solver is faster but is unavailable"
                + (" inside traces." if in_trace else " (scipy not installed)."),
                UserWarning,
            )
    if use_linear_sum_assignment:
        if not _SCIPY_AVAILABLE:
            raise ModuleNotFoundError(
                "`use_linear_sum_assignment=True` requires that `scipy` is installed; the exhaustive"
                f" fallback would enumerate {spk_num}! permutations."
            )
        if in_trace:
            raise ValueError(
                "`use_linear_sum_assignment=True` runs a host-side scipy solver and cannot be used inside"
                " traces (CUDA-graph capture, the engine's micro-batch); pass `use_linear_sum_assignment=False` there."
            )
        return _find_best_perm_by_linear_sum_assignment(metric_mtx, eval_func)
    return _find_best_perm_by_exhaustive_method(metric_mtx, eval_func)


def pit_permutate(preds: Tensor, perm: Tensor) -> Tensor:
    """Reorder the speakers of ``preds`` by ``perm``.

    Example:
        >>> import torch
        >>> preds = torch.tensor([[[1.0, 1.0], [2.0, 2.0]]])
        >>> perm = torch.tensor([[1, 0]])
        >>> pit_permutate(preds, perm)
        tensor([[[2., 2.],
                 [1., 1.]]])
    """
    preds, perm = torch.as_tensor(preds), torch.as_tensor(perm)
    index = perm.reshape(perm.shape + (1,) * (preds.ndim - 2)).long().expand(perm.shape + preds.shape[2:])
    return torch.gather(preds, 1, index)
