"""``RetrievalPrecisionRecallCurve`` and ``RetrievalRecallAtFixedPrecision``
(port of ``metrics_tpu/retrieval/precision_recall_curve.py``).

The per-query curves come from ONE ``index_add_`` of the hits into a dense
``(num_queries, max_k)`` matrix and a cumulative sum along k, with no loop
over queries; the queries' curves are averaged after ``empty_target_action``.
The recall at a fixed precision is read from the averaged curve on its device.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.retrieval.base import RetrievalMetric


def _retrieval_recall_at_fixed_precision(
    precision: Tensor,
    recall: Tensor,
    top_k: Tensor,
    min_precision: float,
) -> Tuple[Tensor, Tensor]:
    """The highest recall among the points whose precision is at least
    ``min_precision``, and its k (the largest such k on a tie); ``(0.0,
    len(top_k))`` when no point qualifies or the best recall is 0."""
    ok = precision >= min_precision
    max_recall = torch.where(ok, recall, float("-inf")).max()
    best_k = torch.where(ok & (recall == max_recall), top_k, -1).max()
    found = ok.any() & (max_recall != 0.0)
    return (torch.where(found, max_recall, 0.0).to(torch.float32),
            torch.where(found, best_k, top_k.shape[0]).to(torch.int32))


class RetrievalPrecisionRecallCurve(RetrievalMetric):
    """The precision@k and recall@k curves for k = 1..max_k, averaged over queries.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.retrieval import RetrievalPrecisionRecallCurve
        >>> metric = RetrievalPrecisionRecallCurve(max_k=3, device="cpu")
        >>> metric.update(torch.tensor([0.9, 0.2, 0.7, 0.4]), torch.tensor([1, 0, 1, 1]),
        ...               indexes=torch.tensor([0, 0, 1, 1]))
        >>> precision, recall, top_k = metric.compute()
        >>> top_k
        tensor([1, 2, 3], dtype=torch.int32)
    """

    higher_is_better = True

    def __init__(
        self,
        max_k: Optional[int] = None,
        adaptive_k: bool = False,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        if max_k is not None and not (isinstance(max_k, int) and max_k > 0):
            raise ValueError("`max_k` has to be a positive integer or None")
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.max_k = max_k
        self.adaptive_k = adaptive_k

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        g = self._grouped()
        max_k = self.max_k if self.max_k is not None else int(torch.max(g.n_per))
        q = g.num_queries
        dev = g.target.device

        # hits per (query, rank < max_k) cell, then cumulative along k
        in_k = (g.rank < max_k).to(torch.float32)
        cells = g.seg * max_k + torch.clamp(g.rank, max=max_k - 1)
        rel = torch.zeros(q * max_k, dtype=torch.float32, device=dev).index_add_(0, cells, g.target * in_k)
        cum_rel = torch.cumsum(rel.reshape(q, max_k), dim=1)

        ks = torch.arange(1, max_k + 1, dtype=torch.float32, device=dev)[None, :]
        denom_k = torch.minimum(ks, g.n_per[:, None]) if self.adaptive_k else ks

        valid = g.pos_per > 0
        precision = torch.where(valid[:, None], cum_rel / denom_k, 0.0)
        recall = torch.where(valid[:, None], cum_rel / torch.clamp(g.pos_per[:, None], min=1.0), 0.0)

        if self.empty_target_action == "error":
            self._raise_on_empty(valid)
            mask = torch.ones_like(valid)
        elif self.empty_target_action == "pos":
            precision = torch.where(valid[:, None], precision, 1.0)
            recall = torch.where(valid[:, None], recall, 1.0)
            mask = torch.ones_like(valid)
        elif self.empty_target_action == "neg":
            mask = torch.ones_like(valid)  # the rows are zero already
        else:  # skip
            mask = valid

        count = torch.clamp(mask.sum(), min=1).to(torch.float32)
        maskf = mask.to(torch.float32)[:, None]
        avg_precision = (precision * maskf).sum(dim=0) / count
        avg_recall = (recall * maskf).sum(dim=0) / count
        top_k = torch.arange(1, max_k + 1, dtype=torch.int32, device=dev)
        return avg_precision, avg_recall, top_k


class RetrievalRecallAtFixedPrecision(RetrievalPrecisionRecallCurve):
    """The highest recall@k whose precision@k reaches ``min_precision``, and its k.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.retrieval import RetrievalRecallAtFixedPrecision
        >>> metric = RetrievalRecallAtFixedPrecision(min_precision=0.5, max_k=3, device="cpu")
        >>> metric.update(torch.tensor([0.9, 0.2, 0.7, 0.4]), torch.tensor([1, 0, 1, 1]),
        ...               indexes=torch.tensor([0, 0, 1, 1]))
        >>> max_recall, best_k = metric.compute()
        >>> (round(float(max_recall), 4), int(best_k))
        (1.0, 3)
    """

    def __init__(
        self,
        min_precision: float = 0.0,
        max_k: Optional[int] = None,
        adaptive_k: bool = False,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            max_k=max_k,
            adaptive_k=adaptive_k,
            empty_target_action=empty_target_action,
            ignore_index=ignore_index,
            **kwargs,
        )
        if not (isinstance(min_precision, float) and 0.0 <= min_precision <= 1.0):
            raise ValueError("`min_precision` has to be a positive float between 0 and 1")
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:  # type: ignore[override]
        precision, recall, top_k = super().compute()
        return _retrieval_recall_at_fixed_precision(precision, recall, top_k, self.min_precision)
