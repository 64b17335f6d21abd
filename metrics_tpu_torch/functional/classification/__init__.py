"""Classification functionals, multiclass half (port of
``metrics_tpu/functional/classification``)."""

from metrics_tpu_torch.functional.classification.accuracy import multiclass_accuracy
from metrics_tpu_torch.functional.classification.confusion_matrix import multiclass_confusion_matrix
from metrics_tpu_torch.functional.classification.f_beta import multiclass_f1_score, multiclass_fbeta_score
from metrics_tpu_torch.functional.classification.stat_scores import multiclass_stat_scores

__all__ = [
    "multiclass_accuracy",
    "multiclass_confusion_matrix",
    "multiclass_f1_score",
    "multiclass_fbeta_score",
    "multiclass_stat_scores",
]
