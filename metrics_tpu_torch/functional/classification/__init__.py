"""Classification functionals (port of ``metrics_tpu/functional/classification``):
the multiclass flagship metrics and the curve family."""

from metrics_tpu_torch.functional.classification.accuracy import multiclass_accuracy
from metrics_tpu_torch.functional.classification.auroc import auroc, binary_auroc, multiclass_auroc, multilabel_auroc
from metrics_tpu_torch.functional.classification.average_precision import (
    average_precision,
    binary_average_precision,
    multiclass_average_precision,
    multilabel_average_precision,
)
from metrics_tpu_torch.functional.classification.confusion_matrix import multiclass_confusion_matrix
from metrics_tpu_torch.functional.classification.f_beta import multiclass_f1_score, multiclass_fbeta_score
from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    binary_precision_recall_curve,
    multiclass_precision_recall_curve,
    multilabel_precision_recall_curve,
    precision_recall_curve,
)
from metrics_tpu_torch.functional.classification.recall_at_fixed_precision import (
    binary_recall_at_fixed_precision,
    multiclass_recall_at_fixed_precision,
    multilabel_recall_at_fixed_precision,
)
from metrics_tpu_torch.functional.classification.roc import binary_roc, multiclass_roc, multilabel_roc, roc
from metrics_tpu_torch.functional.classification.specificity_at_sensitivity import (
    binary_specificity_at_sensitivity,
    multiclass_specificity_at_sensitivity,
    multilabel_specificity_at_sensitivity,
)
from metrics_tpu_torch.functional.classification.stat_scores import multiclass_stat_scores

__all__ = [
    "auroc",
    "average_precision",
    "binary_auroc",
    "binary_average_precision",
    "binary_precision_recall_curve",
    "binary_recall_at_fixed_precision",
    "binary_roc",
    "binary_specificity_at_sensitivity",
    "multiclass_accuracy",
    "multiclass_auroc",
    "multiclass_average_precision",
    "multiclass_confusion_matrix",
    "multiclass_f1_score",
    "multiclass_fbeta_score",
    "multiclass_precision_recall_curve",
    "multiclass_recall_at_fixed_precision",
    "multiclass_roc",
    "multiclass_specificity_at_sensitivity",
    "multiclass_stat_scores",
    "multilabel_auroc",
    "multilabel_average_precision",
    "multilabel_precision_recall_curve",
    "multilabel_recall_at_fixed_precision",
    "multilabel_roc",
    "multilabel_specificity_at_sensitivity",
    "precision_recall_curve",
    "roc",
]
