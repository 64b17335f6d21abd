"""metrics_tpu_torch: the PyTorch and CUDA port of ``metrics_tpu``.

The package mirrors ``metrics_tpu``'s module paths so each port sits where its
reference does. It imports ``torch`` and numpy only, never JAX nor any module
of ``metrics_tpu``. States are tensors on an explicit device; entry points run
on the GPU unless the caller passes ``device="cpu"``.

Where ``metrics_tpu`` ran a Pallas kernel, the port runs a CUDA kernel written
for Hopper (``csrc/``), built with ``nvcc`` at first use. On a CUDA tensor the
kernel runs or the call raises; the kernel's plain PyTorch version serves CPU
tensors only.
"""

__version__ = "0.1.0"

from metrics_tpu_torch import functional
from metrics_tpu_torch.aggregation import CatMetric, MaxMetric, MeanMetric, MinMetric, SumMetric
from metrics_tpu_torch.audio import (
    PermutationInvariantTraining,
    ScaleInvariantSignalDistortionRatio,
    ScaleInvariantSignalNoiseRatio,
    SignalDistortionRatio,
    SignalNoiseRatio,
)
from metrics_tpu_torch.classification import (
    AUROC,
    ROC,
    Accuracy,
    AveragePrecision,
    CalibrationError,
    CohenKappa,
    ConfusionMatrix,
    Dice,
    ExactMatch,
    F1Score,
    FBetaScore,
    HammingDistance,
    HingeLoss,
    JaccardIndex,
    MatthewsCorrCoef,
    Precision,
    PrecisionRecallCurve,
    Recall,
    Specificity,
    StatScores,
)
from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.image import (
    ErrorRelativeGlobalDimensionlessSynthesis,
    MultiScaleStructuralSimilarityIndexMeasure,
    PeakSignalNoiseRatio,
    SpectralAngleMapper,
    SpectralDistortionIndex,
    StructuralSimilarityIndexMeasure,
    TotalVariation,
    UniversalImageQualityIndex,
)
from metrics_tpu_torch.metric import CompositionalMetric, Metric
from metrics_tpu_torch.nominal import CramersV, PearsonsContingencyCoefficient, TheilsU, TschuprowsT
from metrics_tpu_torch.regression import (
    ConcordanceCorrCoef,
    CosineSimilarity,
    ExplainedVariance,
    KendallRankCorrCoef,
    KLDivergence,
    LogCoshError,
    MeanAbsoluteError,
    MeanAbsolutePercentageError,
    MeanSquaredError,
    MeanSquaredLogError,
    PearsonCorrCoef,
    R2Score,
    SpearmanCorrCoef,
    SymmetricMeanAbsolutePercentageError,
    TweedieDevianceScore,
    WeightedMeanAbsolutePercentageError,
)
from metrics_tpu_torch.retrieval import (
    RetrievalFallOut,
    RetrievalHitRate,
    RetrievalMAP,
    RetrievalMRR,
    RetrievalNormalizedDCG,
    RetrievalPrecision,
    RetrievalPrecisionRecallCurve,
    RetrievalRecall,
    RetrievalRecallAtFixedPrecision,
    RetrievalRPrecision,
)
from metrics_tpu_torch.sketch import CardinalitySketch, HeavyHittersSketch, QuantileSketch
from metrics_tpu_torch.wrappers import BootStrapper, ClasswiseWrapper, MetricTracker, MinMaxMetric, MultioutputWrapper
from metrics_tpu_torch import engine  # noqa: E402  (serving runtime; not in __all__, as in the JAX package)

# the names of ``metrics_tpu.__all__`` that the port has so far
__all__ = [
    "functional",
    "Accuracy",
    "AUROC",
    "AveragePrecision",
    "BootStrapper",
    "CalibrationError",
    "CardinalitySketch",
    "CatMetric",
    "ClasswiseWrapper",
    "CohenKappa",
    "CompositionalMetric",
    "ConcordanceCorrCoef",
    "ConfusionMatrix",
    "CosineSimilarity",
    "CramersV",
    "Dice",
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "ExactMatch",
    "ExplainedVariance",
    "F1Score",
    "FBetaScore",
    "HammingDistance",
    "HeavyHittersSketch",
    "HingeLoss",
    "JaccardIndex",
    "KendallRankCorrCoef",
    "KLDivergence",
    "LogCoshError",
    "MatthewsCorrCoef",
    "MaxMetric",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanMetric",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "Metric",
    "MetricCollection",
    "MetricTracker",
    "MinMaxMetric",
    "MinMetric",
    "MultioutputWrapper",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "PermutationInvariantTraining",
    "PearsonCorrCoef",
    "PearsonsContingencyCoefficient",
    "Precision",
    "PrecisionRecallCurve",
    "QuantileSketch",
    "R2Score",
    "Recall",
    "RetrievalFallOut",
    "RetrievalHitRate",
    "RetrievalMAP",
    "RetrievalMRR",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalPrecisionRecallCurve",
    "RetrievalRecall",
    "RetrievalRecallAtFixedPrecision",
    "RetrievalRPrecision",
    "ROC",
    "ScaleInvariantSignalDistortionRatio",
    "ScaleInvariantSignalNoiseRatio",
    "SignalDistortionRatio",
    "SignalNoiseRatio",
    "SpearmanCorrCoef",
    "Specificity",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "StatScores",
    "StructuralSimilarityIndexMeasure",
    "SumMetric",
    "SymmetricMeanAbsolutePercentageError",
    "TheilsU",
    "TotalVariation",
    "TschuprowsT",
    "TweedieDevianceScore",
    "UniversalImageQualityIndex",
    "WeightedMeanAbsolutePercentageError",
]
