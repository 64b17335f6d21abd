"""Dice score functional, with the legacy ``average`` / ``mdmc_average`` API
(port of ``metrics_tpu/functional/classification/dice.py``).

The inputs go through the legacy formatter (``utils/checks.py``
``_input_format_classification``), which decides the input case from shapes
and values (host reads) and one-hots everything to int32 ``(N, C)``. An
ignored class is marked with -1 sentinels in its counts, and a class absent
from both preds and target gets -1 sentinels in the score: the masked
reduction then leaves it out of the mean (NaN with ``average="none"``).
Plain torch code (no kernel): one-hot sums in int32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _input_format_classification
from metrics_tpu_torch.utils.enums import DataType

_ALLOWED_AVERAGE = ("micro", "macro", "weighted", "samples", "none", None)
_ALLOWED_MDMC_AVERAGE = ("global", "samplewise", None)


def _dice_arg_validation(average: Optional[str], mdmc_average: Optional[str], num_classes: Optional[int],
                         ignore_index: Optional[int]) -> None:
    if average not in _ALLOWED_AVERAGE:
        raise ValueError(f"The `average` has to be one of {_ALLOWED_AVERAGE}, got {average}.")
    if mdmc_average not in _ALLOWED_MDMC_AVERAGE:
        raise ValueError(f"The `mdmc_average` has to be one of {_ALLOWED_MDMC_AVERAGE}, got {mdmc_average}.")
    if average in ("macro", "weighted", "none", None) and (num_classes is None or num_classes < 1):
        raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")
    if num_classes is not None and ignore_index is not None and not 0 <= ignore_index < num_classes and num_classes > 1:
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")


def _reduce_stat_scores(
    numerator: Tensor,
    denominator: Tensor,
    weights: Optional[Tensor],
    average: Optional[str],
    mdmc_average: Optional[str],
    zero_division: float = 0.0,
) -> Tensor:
    """Masked score reduction: a zero denominator scores ``zero_division``, a
    negative one marks an ignored class (weight 0 in a mean, NaN unaveraged)."""
    numerator = numerator.to(torch.float32)
    denominator = denominator.to(torch.float32)
    zero_div_mask = denominator == 0
    ignore_mask = denominator < 0

    weights = torch.ones_like(denominator) if weights is None else weights.to(torch.float32)
    numerator = torch.where(zero_div_mask, zero_division, numerator)
    denominator = torch.where(zero_div_mask | ignore_mask, 1.0, denominator)
    weights = torch.where(ignore_mask, 0.0, weights)

    if average not in ("micro", "none", None):
        weights = weights / torch.sum(weights, dim=-1, keepdim=True)

    scores = weights * (numerator / denominator)
    scores = torch.where(torch.isnan(scores), zero_division, scores)

    if mdmc_average == "samplewise":
        if scores.ndim == 0:
            # micro-averaged input of one dimension: ``jnp.mean`` over axis 0 of a
            # scalar raises in the JAX package, where ``torch.mean`` would pass it
            raise IndexError("tuple index out of range")
        scores = torch.mean(scores, dim=0)
        ignore_mask = torch.sum(ignore_mask, dim=0).to(torch.bool)

    if average in ("none", None):
        return torch.where(ignore_mask, float("nan"), scores)
    return torch.sum(scores)


def _stat_scores(preds: Tensor, target: Tensor, reduce: Optional[str] = "micro") -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """int32 tp/fp/tn/fn of 0/1 ``(N, C)`` or ``(N, C, X)`` matrices."""
    if reduce == "micro":
        dim = (0, 1) if preds.ndim == 2 else (1, 2)
    elif reduce == "macro":
        dim = (0,) if preds.ndim == 2 else (2,)
    else:  # samples
        dim = (1,)

    true_pred, false_pred = target == preds, target != preds
    pos_pred, neg_pred = preds == 1, preds == 0

    def count(hit: Tensor) -> Tensor:
        return hit.sum(dim=dim, dtype=torch.int32)

    return (count(true_pred & pos_pred), count(false_pred & pos_pred), count(true_pred & neg_pred),
            count(false_pred & neg_pred))


def _dice_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    reduce: Optional[str] = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = 1,
    threshold: float = 0.5,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Format, reshape for the multi-dim mode, count, and mark the ignored class."""
    preds_oh, target_oh, case = _input_format_classification(
        preds, target, threshold=threshold, top_k=top_k, num_classes=num_classes, multiclass=multiclass,
        ignore_index=ignore_index,
    )
    n_cols = preds_oh.shape[1]

    if ignore_index is not None and not 0 <= ignore_index < n_cols and n_cols > 1:
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {n_cols} classes")

    if case == DataType.MULTIDIM_MULTICLASS and mdmc_reduce == "samplewise":
        # back to (N, C, X): the formatter flattened (N, C, ...) to (N * X, C)
        n = target.shape[0]
        preds_oh = torch.movedim(preds_oh.reshape(n, -1, n_cols), 1, -1)
        target_oh = torch.movedim(target_oh.reshape(n, -1, n_cols), 1, -1)

    if ignore_index is not None and n_cols > 1 and reduce == "micro":
        # the ignored class contributes nothing
        keep = (torch.arange(n_cols, device=preds_oh.device) != ignore_index).to(preds_oh.dtype)
        keep = keep.reshape((1, -1) + (1,) * (preds_oh.ndim - 2))
        preds_oh = preds_oh * keep
        target_oh = target_oh * keep

    tp, fp, tn, fn = _stat_scores(preds_oh, target_oh, reduce=reduce)

    if ignore_index is not None and n_cols > 1 and reduce == "macro":
        ignored = torch.arange(tp.shape[-1], device=tp.device) == ignore_index
        tp, fp, tn, fn = (torch.where(ignored, -1, s) for s in (tp, fp, tn, fn))
    return tp, fp, tn, fn


def _dice_compute(
    tp: Tensor,
    fp: Tensor,
    fn: Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
    zero_division: float = 0.0,
) -> Tensor:
    """Dice = 2 tp / (2 tp + fp + fn), classes absent from both sides left out
    of ``macro`` and ``none`` (unless samplewise)."""
    numerator = 2 * tp
    denominator = 2 * tp + fp + fn

    if average in ("macro", "none", None) and mdmc_average != "samplewise":
        absent = (tp + fp + fn) == 0
        numerator = torch.where(absent, -1, numerator)
        denominator = torch.where(absent, -1, denominator)

    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != "weighted" else (tp + fn),
        average=average,
        mdmc_average=mdmc_average,
        zero_division=zero_division,
    )


def dice(
    preds: Tensor,
    target: Tensor,
    zero_division: float = 0.0,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = "global",
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Dice score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import dice
        >>> dice(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]))
        tensor(0.7500)
    """
    _dice_arg_validation(average, mdmc_average, num_classes, ignore_index)
    reduce = "macro" if average in ("weighted", "none", None) else average
    tp, fp, _, fn = _dice_stat_scores_update(
        preds, target, reduce=reduce, mdmc_reduce=mdmc_average, num_classes=num_classes,
        top_k=top_k, threshold=threshold, ignore_index=ignore_index,
    )
    return _dice_compute(tp, fp, fn, average, mdmc_average, zero_division)
