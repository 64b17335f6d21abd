"""Classification module metrics, multiclass half (port of ``metrics_tpu/classification``)."""

from metrics_tpu_torch.classification.accuracy import MulticlassAccuracy
from metrics_tpu_torch.classification.confusion_matrix import MulticlassConfusionMatrix
from metrics_tpu_torch.classification.f_beta import MulticlassF1Score, MulticlassFBetaScore
from metrics_tpu_torch.classification.stat_scores import MulticlassStatScores

__all__ = [
    "MulticlassAccuracy",
    "MulticlassConfusionMatrix",
    "MulticlassF1Score",
    "MulticlassFBetaScore",
    "MulticlassStatScores",
]
