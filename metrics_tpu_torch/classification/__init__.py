"""Classification module metrics (port of ``metrics_tpu/classification``): the
stat-score family (binary, multiclass, multilabel and the task façades), the
curve family, and the confusion-matrix family (Jaccard, Cohen's kappa,
Matthews)."""

from metrics_tpu_torch.classification.accuracy import Accuracy, BinaryAccuracy, MulticlassAccuracy, MultilabelAccuracy
from metrics_tpu_torch.classification.auroc import AUROC, BinaryAUROC, MulticlassAUROC, MultilabelAUROC
from metrics_tpu_torch.classification.average_precision import (
    AveragePrecision,
    BinaryAveragePrecision,
    MulticlassAveragePrecision,
    MultilabelAveragePrecision,
)
from metrics_tpu_torch.classification.cohen_kappa import BinaryCohenKappa, CohenKappa, MulticlassCohenKappa
from metrics_tpu_torch.classification.confusion_matrix import (
    BinaryConfusionMatrix,
    ConfusionMatrix,
    MulticlassConfusionMatrix,
    MultilabelConfusionMatrix,
)
from metrics_tpu_torch.classification.f_beta import (
    BinaryF1Score,
    BinaryFBetaScore,
    F1Score,
    FBetaScore,
    MulticlassF1Score,
    MulticlassFBetaScore,
    MultilabelF1Score,
    MultilabelFBetaScore,
)
from metrics_tpu_torch.classification.jaccard import (
    BinaryJaccardIndex,
    JaccardIndex,
    MulticlassJaccardIndex,
    MultilabelJaccardIndex,
)
from metrics_tpu_torch.classification.matthews_corrcoef import (
    BinaryMatthewsCorrCoef,
    MatthewsCorrCoef,
    MulticlassMatthewsCorrCoef,
    MultilabelMatthewsCorrCoef,
)
from metrics_tpu_torch.classification.precision_recall import (
    BinaryPrecision,
    BinaryRecall,
    MulticlassPrecision,
    MulticlassRecall,
    MultilabelPrecision,
    MultilabelRecall,
    Precision,
    Recall,
)
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
from metrics_tpu_torch.classification.specificity import (
    BinarySpecificity,
    MulticlassSpecificity,
    MultilabelSpecificity,
    Specificity,
)
from metrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    StatScores,
)

__all__ = [
    "Accuracy",
    "AUROC",
    "AveragePrecision",
    "BinaryAccuracy",
    "BinaryAUROC",
    "BinaryAveragePrecision",
    "BinaryCohenKappa",
    "BinaryConfusionMatrix",
    "BinaryF1Score",
    "BinaryFBetaScore",
    "BinaryJaccardIndex",
    "BinaryMatthewsCorrCoef",
    "BinaryPrecision",
    "BinaryPrecisionRecallCurve",
    "BinaryRecall",
    "BinaryRecallAtFixedPrecision",
    "BinaryROC",
    "BinarySpecificity",
    "BinarySpecificityAtSensitivity",
    "BinaryStatScores",
    "CohenKappa",
    "ConfusionMatrix",
    "F1Score",
    "FBetaScore",
    "JaccardIndex",
    "MatthewsCorrCoef",
    "MulticlassAccuracy",
    "MulticlassAUROC",
    "MulticlassAveragePrecision",
    "MulticlassCohenKappa",
    "MulticlassConfusionMatrix",
    "MulticlassF1Score",
    "MulticlassFBetaScore",
    "MulticlassJaccardIndex",
    "MulticlassMatthewsCorrCoef",
    "MulticlassPrecision",
    "MulticlassPrecisionRecallCurve",
    "MulticlassRecall",
    "MulticlassRecallAtFixedPrecision",
    "MulticlassROC",
    "MulticlassSpecificity",
    "MulticlassSpecificityAtSensitivity",
    "MulticlassStatScores",
    "MultilabelAccuracy",
    "MultilabelAUROC",
    "MultilabelAveragePrecision",
    "MultilabelConfusionMatrix",
    "MultilabelF1Score",
    "MultilabelFBetaScore",
    "MultilabelJaccardIndex",
    "MultilabelMatthewsCorrCoef",
    "MultilabelPrecision",
    "MultilabelPrecisionRecallCurve",
    "MultilabelRecall",
    "MultilabelRecallAtFixedPrecision",
    "MultilabelROC",
    "MultilabelSpecificity",
    "MultilabelSpecificityAtSensitivity",
    "MultilabelStatScores",
    "Precision",
    "PrecisionRecallCurve",
    "Recall",
    "RecallAtFixedPrecision",
    "ROC",
    "Specificity",
    "SpecificityAtSensitivity",
    "StatScores",
]
