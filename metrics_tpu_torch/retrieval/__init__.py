"""Retrieval modules (port of ``metrics_tpu/retrieval``)."""

from metrics_tpu_torch.retrieval.base import GroupedRanks, RetrievalMetric, group_by_query
from metrics_tpu_torch.retrieval.precision_recall_curve import (
    RetrievalPrecisionRecallCurve,
    RetrievalRecallAtFixedPrecision,
)
from metrics_tpu_torch.retrieval.rank_metrics import (
    RetrievalFallOut,
    RetrievalHitRate,
    RetrievalMAP,
    RetrievalMRR,
    RetrievalNormalizedDCG,
    RetrievalPrecision,
    RetrievalRecall,
    RetrievalRPrecision,
)

__all__ = [
    "GroupedRanks",
    "RetrievalFallOut",
    "RetrievalHitRate",
    "RetrievalMAP",
    "RetrievalMRR",
    "RetrievalMetric",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalPrecisionRecallCurve",
    "RetrievalRecall",
    "RetrievalRecallAtFixedPrecision",
    "RetrievalRPrecision",
    "group_by_query",
]
