"""The ranked-retrieval modules over the whole-batch group-by-query compute
(port of ``metrics_tpu/retrieval/rank_metrics.py``): MAP, MRR, precision,
recall, fall-out (empty on NEGATIVE targets), hit rate, R-precision and nDCG
(graded targets allowed).

Each ``_query_values`` is a closed-form expression over
:class:`~metrics_tpu_torch.retrieval.base.GroupedRanks`, computed for every
query at once.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.retrieval._utils import _validate_k
from metrics_tpu_torch.retrieval.base import GroupedRanks, RetrievalMetric
from metrics_tpu_torch.utils.compute import _safe_divide


class RetrievalMAP(RetrievalMetric):
    """Mean Average Precision over queries.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalMAP
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalMAP(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> metric.compute()
        tensor(0.7917)
    """

    def _query_values(self, g: GroupedRanks) -> Tensor:
        prec_at_hit = g.cum_hits / (g.rank.to(torch.float32) + 1.0)
        ap_sum = g.segment_sum(prec_at_hit * g.target)
        return _safe_divide(ap_sum, g.pos_per)


class RetrievalMRR(RetrievalMetric):
    """Mean Reciprocal Rank over queries.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalMRR
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalMRR(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> metric.compute()
        tensor(0.7500)
    """

    def _query_values(self, g: GroupedRanks) -> Tensor:
        n = g.rank.shape[0]
        first_hit = g.segment_min(torch.where(g.target > 0, g.rank, n))
        return torch.where(g.pos_per > 0, 1.0 / (first_hit.to(torch.float32) + 1.0), 0.0)


class RetrievalPrecision(RetrievalMetric):
    """Precision@k; ``adaptive_k`` clamps k to each query's size.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalPrecision
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalPrecision(k=2, device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> metric.compute()
        tensor(0.5000)
    """

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        k: Optional[int] = None,
        adaptive_k: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        _validate_k(k)
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.k = k
        self.adaptive_k = adaptive_k

    def _query_values(self, g: GroupedRanks) -> Tensor:
        if self.k is None:
            k_eff = g.n_per
        elif self.adaptive_k:
            k_eff = torch.clamp(g.n_per, max=float(self.k))
        else:
            k_eff = torch.full_like(g.n_per, float(self.k))
        relevant = g.segment_sum(g.target * g.k_mask(k_eff))
        return _safe_divide(relevant, k_eff)


class RetrievalRecall(RetrievalMetric):
    """Recall@k.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalRecall
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalRecall(k=2, device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> metric.compute()
        tensor(0.7500)
    """

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        k: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        _validate_k(k)
        self.k = k

    def _query_values(self, g: GroupedRanks) -> Tensor:
        k_eff = g.n_per if self.k is None else torch.full_like(g.n_per, float(self.k))
        relevant = g.segment_sum(g.target * g.k_mask(k_eff))
        return _safe_divide(relevant, g.pos_per)


class RetrievalFallOut(RetrievalMetric):
    """Fall-out@k: retrieved-negative fraction of all negatives; lower is better.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalFallOut
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalFallOut(k=2, device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> metric.compute()
        tensor(0.5000)
    """

    higher_is_better = False
    _empty_on = "negatives"

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        k: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        _validate_k(k)
        self.k = k

    def _query_values(self, g: GroupedRanks) -> Tensor:
        k_eff = g.n_per if self.k is None else torch.full_like(g.n_per, float(self.k))
        neg = 1.0 - g.target
        retrieved_neg = g.segment_sum(neg * g.k_mask(k_eff))
        return _safe_divide(retrieved_neg, g.neg_per)


class RetrievalHitRate(RetrievalMetric):
    """Hit rate@k: 1 if any relevant document in the top-k.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalHitRate
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalHitRate(k=2, device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> metric.compute()
        tensor(1.)
    """

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        k: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        _validate_k(k)
        self.k = k

    def _query_values(self, g: GroupedRanks) -> Tensor:
        k_eff = g.n_per if self.k is None else torch.full_like(g.n_per, float(self.k))
        hits = g.segment_sum(g.target * g.k_mask(k_eff))
        return (hits > 0).to(torch.float32)


class RetrievalRPrecision(RetrievalMetric):
    """Precision at k = (# relevant documents of the query).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalRPrecision
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalRPrecision(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> metric.compute()
        tensor(0.7500)
    """

    def _query_values(self, g: GroupedRanks) -> Tensor:
        in_top_r = (g.rank.to(torch.float32) < g.pos_per[g.seg]).to(torch.float32)
        relevant = g.segment_sum(g.target * in_top_r)
        return _safe_divide(relevant, g.pos_per)


class RetrievalNormalizedDCG(RetrievalMetric):
    """nDCG@k with raw-gain DCG over possibly non-binary targets.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalNormalizedDCG
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalNormalizedDCG(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> round(float(metric.compute()), 4)
        0.8467
    """

    allow_non_binary_target = True

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        k: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        _validate_k(k)
        self.k = k

    def _query_values(self, g: GroupedRanks) -> Tensor:
        k_eff = g.n_per if self.k is None else torch.clamp(g.n_per, max=float(self.k))
        mask = g.k_mask(k_eff)
        discount = 1.0 / torch.log2(g.rank.to(torch.float32) + 2.0)
        dcg = g.segment_sum(g.target * discount * mask)
        idcg = g.segment_sum(g.ideal_target * discount * mask)
        return torch.where(idcg > 0, _safe_divide(dcg, idcg), 0.0)
