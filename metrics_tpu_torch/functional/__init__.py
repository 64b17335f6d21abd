"""Functional metrics (port of ``metrics_tpu/functional``)."""

from metrics_tpu_torch.functional.classification import (
    multiclass_accuracy,
    multiclass_confusion_matrix,
    multiclass_f1_score,
    multiclass_fbeta_score,
    multiclass_stat_scores,
)
from metrics_tpu_torch.functional.sketch import approx_count_distinct, approx_heavy_hitters, approx_quantiles

__all__ = [
    "approx_count_distinct",
    "approx_heavy_hitters",
    "approx_quantiles",
    "multiclass_accuracy",
    "multiclass_confusion_matrix",
    "multiclass_f1_score",
    "multiclass_fbeta_score",
    "multiclass_stat_scores",
]
