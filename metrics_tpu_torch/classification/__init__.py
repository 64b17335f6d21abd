"""Classification module metrics (port of ``metrics_tpu/classification``): the
multiclass stat-score metrics and the curve family."""

from metrics_tpu_torch.classification.accuracy import MulticlassAccuracy
from metrics_tpu_torch.classification.auroc import AUROC, BinaryAUROC, MulticlassAUROC, MultilabelAUROC
from metrics_tpu_torch.classification.average_precision import (
    AveragePrecision,
    BinaryAveragePrecision,
    MulticlassAveragePrecision,
    MultilabelAveragePrecision,
)
from metrics_tpu_torch.classification.confusion_matrix import MulticlassConfusionMatrix
from metrics_tpu_torch.classification.f_beta import MulticlassF1Score, MulticlassFBetaScore
from metrics_tpu_torch.classification.precision_recall import MulticlassPrecision, MulticlassRecall
from metrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    PrecisionRecallCurve,
)
from metrics_tpu_torch.classification.recall_at_fixed_precision import (
    BinaryRecallAtFixedPrecision,
    MulticlassRecallAtFixedPrecision,
    MultilabelRecallAtFixedPrecision,
    RecallAtFixedPrecision,
)
from metrics_tpu_torch.classification.roc import ROC, BinaryROC, MulticlassROC, MultilabelROC
from metrics_tpu_torch.classification.specificity_at_sensitivity import (
    BinarySpecificityAtSensitivity,
    MulticlassSpecificityAtSensitivity,
    MultilabelSpecificityAtSensitivity,
    SpecificityAtSensitivity,
)
from metrics_tpu_torch.classification.specificity import MulticlassSpecificity
from metrics_tpu_torch.classification.stat_scores import MulticlassStatScores

__all__ = [
    "AUROC",
    "AveragePrecision",
    "BinaryAUROC",
    "BinaryAveragePrecision",
    "BinaryPrecisionRecallCurve",
    "BinaryRecallAtFixedPrecision",
    "BinaryROC",
    "BinarySpecificityAtSensitivity",
    "MulticlassAccuracy",
    "MulticlassAUROC",
    "MulticlassAveragePrecision",
    "MulticlassConfusionMatrix",
    "MulticlassF1Score",
    "MulticlassFBetaScore",
    "MulticlassPrecision",
    "MulticlassPrecisionRecallCurve",
    "MulticlassRecall",
    "MulticlassRecallAtFixedPrecision",
    "MulticlassROC",
    "MulticlassSpecificity",
    "MulticlassSpecificityAtSensitivity",
    "MulticlassStatScores",
    "MultilabelAUROC",
    "MultilabelAveragePrecision",
    "MultilabelPrecisionRecallCurve",
    "MultilabelRecallAtFixedPrecision",
    "MultilabelROC",
    "MultilabelSpecificityAtSensitivity",
    "PrecisionRecallCurve",
    "RecallAtFixedPrecision",
    "ROC",
    "SpecificityAtSensitivity",
]
