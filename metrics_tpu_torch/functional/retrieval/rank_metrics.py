"""Per-query retrieval functionals (port of
``metrics_tpu/functional/retrieval/rank_metrics.py``): average precision,
fall-out, hit rate, nDCG, precision, the precision-recall curve, R-precision,
recall and reciprocal rank.

Each takes the documents of ONE query; grouping over queries lives in
``metrics_tpu_torch.retrieval``. A query without a positive target scores
0.0, through ``torch.where``, so no value is read on the host. Every value is
float32, and the curve's ``top_k`` int32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.retrieval._utils import (
    _check_retrieval_functional_inputs,
    _target_by_pred_rank,
    _validate_k,
)
from metrics_tpu_torch.utils.compute import _safe_divide


def _ranked(preds: Tensor, target: Tensor) -> Tensor:
    return _target_by_pred_rank(preds, target).to(torch.float32)


def _positives(target: Tensor) -> Tensor:
    return target.sum().to(torch.float32)


def _check_adaptive_k(adaptive_k: bool) -> None:
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")


def retrieval_average_precision(preds: Tensor, target: Tensor) -> Tensor:
    """Average precision: the mean of precision@rank over the hits' ranks.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_average_precision
        >>> retrieval_average_precision(torch.tensor([0.9, 0.2, 0.7, 0.4]), torch.tensor([1, 0, 1, 1]))
        tensor(1.)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    t = _ranked(preds, target)
    cum_hits = torch.cumsum(t, dim=0)
    prec_at = cum_hits / torch.arange(1, t.shape[0] + 1, dtype=torch.float32, device=t.device)
    total = t.sum()
    return torch.where(total > 0, (prec_at * t).sum() / torch.clamp(total, min=1.0), 0.0)


def retrieval_precision(preds: Tensor, target: Tensor, k: Optional[int] = None, adaptive_k: bool = False) -> Tensor:
    """Precision@k; ``adaptive_k`` clamps k to the query's size.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_precision
        >>> retrieval_precision(torch.tensor([0.9, 0.2, 0.7, 0.4]), torch.tensor([1, 0, 1, 1]), k=2)
        tensor(1.)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    _check_adaptive_k(adaptive_k)
    _validate_k(k)
    n = preds.shape[0]
    if k is None or (adaptive_k and k > n):
        k = n
    relevant = _ranked(preds, target)[: min(k, n)].sum()
    return torch.where(target.sum() > 0, relevant / k, 0.0)


def retrieval_recall(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """Recall@k.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_recall
        >>> retrieval_recall(torch.tensor([0.9, 0.2, 0.7, 0.4]), torch.tensor([1, 0, 1, 1]), k=2)
        tensor(0.6667)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    _validate_k(k)
    n = preds.shape[0]
    k = n if k is None else k
    total = _positives(target)
    relevant = _ranked(preds, target)[: min(k, n)].sum()
    return torch.where(total > 0, relevant / torch.clamp(total, min=1.0), 0.0)


def retrieval_fall_out(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """Fall-out@k: the share of the non-relevant documents retrieved in the top k.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_fall_out
        >>> retrieval_fall_out(torch.tensor([0.9, 0.2, 0.7, 0.4]), torch.tensor([1, 0, 1, 1]))
        tensor(1.)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    _validate_k(k)
    n = preds.shape[0]
    k = n if k is None else k
    neg = 1 - _ranked(preds, target)
    total_neg = neg.sum()
    retrieved_neg = neg[: min(k, n)].sum()
    return torch.where(total_neg > 0, retrieved_neg / torch.clamp(total_neg, min=1.0), 0.0)


def retrieval_hit_rate(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """1.0 if a relevant document is in the top k, else 0.0.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_hit_rate
        >>> retrieval_hit_rate(torch.tensor([0.9, 0.2, 0.7, 0.4]), torch.tensor([1, 0, 1, 1]))
        tensor(1.)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    _validate_k(k)
    n = preds.shape[0]
    k = n if k is None else k
    return (_ranked(preds, target)[: min(k, n)].sum() > 0).to(torch.float32)


def retrieval_r_precision(preds: Tensor, target: Tensor) -> Tensor:
    """Precision at k = the query's number of relevant documents.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_r_precision
        >>> retrieval_r_precision(torch.tensor([0.9, 0.2, 0.7, 0.4]), torch.tensor([1, 0, 1, 1]))
        tensor(1.)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    t = _ranked(preds, target)
    total = _positives(target)
    ranks = torch.arange(t.shape[0], dtype=torch.float32, device=t.device)
    relevant = (t * (ranks < total)).sum()
    return torch.where(total > 0, relevant / torch.clamp(total, min=1.0), 0.0)


def retrieval_reciprocal_rank(preds: Tensor, target: Tensor) -> Tensor:
    """1 / the rank of the first relevant document.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_reciprocal_rank
        >>> retrieval_reciprocal_rank(torch.tensor([0.9, 0.2, 0.7, 0.4]), torch.tensor([1, 0, 1, 1]))
        tensor(1.)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    t = _ranked(preds, target)
    first = torch.argmax(t)  # the first occurrence of the largest value: the top-ranked hit
    return torch.where(target.sum() > 0, 1.0 / (first.to(torch.float32) + 1.0), 0.0)


def _dcg(target: Tensor) -> Tensor:
    denom = torch.log2(torch.arange(target.shape[-1], dtype=torch.float32, device=target.device) + 2.0)
    return (target / denom).sum(dim=-1)


def retrieval_normalized_dcg(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """nDCG@k with the target values as gains (graded targets allowed).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_normalized_dcg
        >>> retrieval_normalized_dcg(torch.tensor([0.9, 0.2, 0.7, 0.4]), torch.tensor([1, 0, 1, 1]))
        tensor(1.)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target, allow_non_binary_target=True)
    _validate_k(k)
    n = preds.shape[0]
    k = n if k is None else k
    target = target.to(torch.float32)
    sorted_target = _target_by_pred_rank(preds, target)[: min(k, n)]
    ideal_target = torch.flip(torch.sort(target).values, (0,))[: min(k, n)]
    ideal_dcg = _dcg(ideal_target)
    target_dcg = _dcg(sorted_target)
    return torch.where(ideal_dcg > 0, _safe_divide(target_dcg, ideal_dcg), 0.0)


def retrieval_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    max_k: Optional[int] = None,
    adaptive_k: bool = False,
) -> Tuple[Tensor, Tensor, Tensor]:
    """``(precision@k, recall@k, k)`` for k = 1..max_k over one query; with
    ``adaptive_k``, k past the query's size stays at its size.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_precision_recall_curve
        >>> precision, recall, top_k = retrieval_precision_recall_curve(
        ...     torch.tensor([0.9, 0.2, 0.7, 0.4]), torch.tensor([1, 0, 1, 1]), max_k=2)
        >>> recall
        tensor([0.3333, 0.6667])
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    _check_adaptive_k(adaptive_k)
    if max_k is not None and not (isinstance(max_k, int) and max_k > 0):
        raise ValueError("`max_k` has to be a positive integer or None")
    n = preds.shape[0]
    max_k = n if max_k is None else max_k
    dev = preds.device

    topk = torch.arange(1, max_k + 1, dtype=torch.float32, device=dev)
    if adaptive_k and max_k > n:
        topk = torch.clamp(topk, max=float(n))

    t = _ranked(preds, target)[: min(max_k, n)]
    t = torch.nn.functional.pad(t, (0, max(0, max_k - t.shape[0])))
    cum_rel = torch.cumsum(t, dim=0)
    total = _positives(target)
    has_pos = total > 0
    recall = torch.where(has_pos, cum_rel / torch.clamp(total, min=1.0), 0.0)
    precision = torch.where(has_pos, cum_rel / topk, 0.0)
    return precision, recall, topk.to(torch.int32)
