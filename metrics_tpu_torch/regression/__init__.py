"""Regression module metrics (port of ``metrics_tpu/regression``)."""

from metrics_tpu_torch.regression.basic import (
    LogCoshError,
    MeanAbsoluteError,
    MeanAbsolutePercentageError,
    MeanSquaredError,
    MeanSquaredLogError,
    SymmetricMeanAbsolutePercentageError,
    WeightedMeanAbsolutePercentageError,
)
from metrics_tpu_torch.regression.misc import (
    CosineSimilarity,
    KendallRankCorrCoef,
    KLDivergence,
    SpearmanCorrCoef,
    TweedieDevianceScore,
)
from metrics_tpu_torch.regression.moments import (
    ConcordanceCorrCoef,
    ExplainedVariance,
    PearsonCorrCoef,
    R2Score,
)

__all__ = [
    "ConcordanceCorrCoef",
    "CosineSimilarity",
    "ExplainedVariance",
    "KendallRankCorrCoef",
    "KLDivergence",
    "LogCoshError",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "PearsonCorrCoef",
    "R2Score",
    "SpearmanCorrCoef",
    "SymmetricMeanAbsolutePercentageError",
    "TweedieDevianceScore",
    "WeightedMeanAbsolutePercentageError",
]
