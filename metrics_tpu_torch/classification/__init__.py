"""Classification module metrics (port of ``metrics_tpu/classification``): the
stat-score family (binary, multiclass, multilabel and the task façades), the
curve family, the confusion-matrix family (Jaccard, Cohen's kappa,
Matthews), and the rest: Hamming distance, exact match, calibration error,
hinge loss, the multilabel ranking metrics and Dice."""

from metrics_tpu_torch.classification.accuracy import Accuracy, BinaryAccuracy, MulticlassAccuracy, MultilabelAccuracy
from metrics_tpu_torch.classification.auroc import AUROC, BinaryAUROC, MulticlassAUROC, MultilabelAUROC
from metrics_tpu_torch.classification.average_precision import (
    AveragePrecision,
    BinaryAveragePrecision,
    MulticlassAveragePrecision,
    MultilabelAveragePrecision,
)
from metrics_tpu_torch.classification.calibration_error import (
    BinaryCalibrationError,
    CalibrationError,
    MulticlassCalibrationError,
)
from metrics_tpu_torch.classification.cohen_kappa import BinaryCohenKappa, CohenKappa, MulticlassCohenKappa
from metrics_tpu_torch.classification.confusion_matrix import (
    BinaryConfusionMatrix,
    ConfusionMatrix,
    MulticlassConfusionMatrix,
    MultilabelConfusionMatrix,
)
from metrics_tpu_torch.classification.dice import Dice
from metrics_tpu_torch.classification.exact_match import ExactMatch, MulticlassExactMatch, MultilabelExactMatch
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
from metrics_tpu_torch.classification.hamming import (
    BinaryHammingDistance,
    HammingDistance,
    MulticlassHammingDistance,
    MultilabelHammingDistance,
)
from metrics_tpu_torch.classification.hinge import BinaryHingeLoss, HingeLoss, MulticlassHingeLoss
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
from metrics_tpu_torch.classification.ranking import (
    MultilabelCoverageError,
    MultilabelRankingAveragePrecision,
    MultilabelRankingLoss,
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
    "BinaryCalibrationError",
    "BinaryCohenKappa",
    "BinaryConfusionMatrix",
    "BinaryF1Score",
    "BinaryFBetaScore",
    "BinaryHammingDistance",
    "BinaryHingeLoss",
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
    "CalibrationError",
    "CohenKappa",
    "ConfusionMatrix",
    "Dice",
    "ExactMatch",
    "F1Score",
    "FBetaScore",
    "HammingDistance",
    "HingeLoss",
    "JaccardIndex",
    "MatthewsCorrCoef",
    "MulticlassAccuracy",
    "MulticlassAUROC",
    "MulticlassAveragePrecision",
    "MulticlassCalibrationError",
    "MulticlassCohenKappa",
    "MulticlassConfusionMatrix",
    "MulticlassExactMatch",
    "MulticlassF1Score",
    "MulticlassFBetaScore",
    "MulticlassHammingDistance",
    "MulticlassHingeLoss",
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
    "MultilabelCoverageError",
    "MultilabelExactMatch",
    "MultilabelF1Score",
    "MultilabelFBetaScore",
    "MultilabelHammingDistance",
    "MultilabelJaccardIndex",
    "MultilabelMatthewsCorrCoef",
    "MultilabelPrecision",
    "MultilabelPrecisionRecallCurve",
    "MultilabelRankingAveragePrecision",
    "MultilabelRankingLoss",
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
