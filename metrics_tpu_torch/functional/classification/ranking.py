"""Multilabel ranking functionals: coverage error, label ranking average
precision and label ranking loss (port of
``metrics_tpu/functional/classification/ranking.py``).

Ranks are computed for the whole batch at once: the average precision
compares every pair of labels of a sample, an ``(N, L, L)`` tensor in the
scores' dtype, with ties counted at the maximum rank; the loss ranks by a
stable double argsort (ties broken by position). Plain torch code (no kernel).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.stat_scores import _ignore_mask, _label32, _sigmoid_if_logits
from metrics_tpu_torch.utils.checks import _as_x32, _check_same_shape
from metrics_tpu_torch.utils.compute import _safe_divide


def _ranking_reduce(score: Tensor, n_elements: Tensor) -> Tensor:
    return _safe_divide(score, n_elements)


def _multilabel_ranking_arg_validation(num_labels: int, ignore_index: Optional[int] = None) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _multilabel_ranking_tensor_validation(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    _check_same_shape(preds, target)
    if preds.shape[1] != num_labels:
        raise ValueError(f"Expected `preds.shape[1]={preds.shape[1]}` to equal `num_labels={num_labels}`")
    if not preds.is_floating_point():
        name = str(_as_x32(preds).dtype).replace("torch.", "")
        raise ValueError(f"Expected preds tensor to be floating point, but received input with dtype {name}")


def _multilabel_ranking_format(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """``(N, L, ...)`` to ``(N * ..., L)`` rows, scores through a sigmoid if
    they are logits, ignored labels zeroed, and the keep mask."""
    preds = torch.movedim(_as_x32(preds), 1, -1).reshape(-1, num_labels)
    target = torch.movedim(_label32(target), 1, -1).reshape(-1, num_labels)
    mask = _ignore_mask(target, ignore_index)
    return _sigmoid_if_logits(preds), torch.where(mask, target, 0), mask


def _count(n: int, like: Tensor) -> Tensor:
    return torch.tensor(n, dtype=torch.float32, device=like.device)


def _multilabel_coverage_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Per sample, how far down the ranking all its relevant labels lie, summed."""
    # the lowest score among the relevant labels (the offset lifts the others above every score)
    offset = torch.where(target == 0, torch.abs(torch.min(preds)) + 10.0, 0.0)
    preds_min = torch.amin(preds + offset, dim=1)
    coverage = torch.sum(preds >= preds_min[:, None], dim=1).to(torch.float32)
    return torch.sum(coverage), _count(coverage.shape[0], coverage)


def multilabel_coverage_error(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multilabel coverage error."""
    if validate_args:
        _multilabel_ranking_arg_validation(num_labels, ignore_index)
        _multilabel_ranking_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, _ = _multilabel_ranking_format(preds, target, num_labels, ignore_index)
    coverage, total = _multilabel_coverage_error_update(preds, target)
    return _ranking_reduce(coverage, total)


def _multilabel_ranking_average_precision_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Label ranking average precision, summed over samples.

    ``rank_all[i, j]`` counts the labels k with ``preds[i, k] >= preds[i, j]``,
    ``rank_rel[i, j]`` the relevant ones among them; a sample scores the mean of
    ``rank_rel / rank_all`` over its relevant labels, and 1 when none or all
    are relevant."""
    n_labels = preds.shape[1]
    relevant = (target == 1).to(preds.dtype)  # (N, L)
    ge = (preds[:, :, None] <= preds[:, None, :]).to(preds.dtype)  # ge[i, j, k] = p[i, k] >= p[i, j]
    rank_all = torch.sum(ge, dim=2)
    rank_rel = torch.bmm(ge, relevant[:, :, None])[:, :, 0]
    n_rel = torch.sum(relevant, dim=1)
    per_label = _safe_divide(rank_rel, rank_all) * relevant
    score = _safe_divide(torch.sum(per_label, dim=1), n_rel)
    score = torch.where((n_rel == 0) | (n_rel == n_labels), 1.0, score)
    return torch.sum(score), _count(preds.shape[0], preds)


def multilabel_ranking_average_precision(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Label ranking average precision."""
    if validate_args:
        _multilabel_ranking_arg_validation(num_labels, ignore_index)
        _multilabel_ranking_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, _ = _multilabel_ranking_format(preds, target, num_labels, ignore_index)
    score, total = _multilabel_ranking_average_precision_update(preds, target)
    return _ranking_reduce(score, total)


def _multilabel_ranking_loss_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Label ranking loss, summed over samples; samples with no or every label
    relevant add 0 (and still count in the total)."""
    n_labels = preds.shape[1]
    relevant = (target == 1).to(preds.dtype)
    n_rel = torch.sum(relevant, dim=1)
    valid = (n_rel > 0) & (n_rel < n_labels)
    # ascending positions, ties broken by position
    inverse = torch.argsort(torch.argsort(preds, dim=1, stable=True), dim=1, stable=True).to(preds.dtype)
    per_label_loss = (n_labels - inverse) * relevant
    correction = 0.5 * n_rel * (n_rel + 1)
    denom = n_rel * (n_labels - n_rel)
    loss = _safe_divide(torch.sum(per_label_loss, dim=1) - correction, denom)
    loss = torch.where(valid, loss, 0.0)
    return torch.sum(loss), _count(preds.shape[0], preds)


def multilabel_ranking_loss(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Label ranking loss."""
    if validate_args:
        _multilabel_ranking_arg_validation(num_labels, ignore_index)
        _multilabel_ranking_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, _ = _multilabel_ranking_format(preds, target, num_labels, ignore_index)
    loss, total = _multilabel_ranking_loss_update(preds, target)
    return _ranking_reduce(loss, total)
