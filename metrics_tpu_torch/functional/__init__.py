"""Functional metrics (port of ``metrics_tpu/functional``)."""

from metrics_tpu_torch.functional.classification import (
    multiclass_accuracy,
    multiclass_confusion_matrix,
    multiclass_f1_score,
    multiclass_fbeta_score,
    multiclass_stat_scores,
)

__all__ = [
    "multiclass_accuracy",
    "multiclass_confusion_matrix",
    "multiclass_f1_score",
    "multiclass_fbeta_score",
    "multiclass_stat_scores",
]
