"""Regression functionals (port of ``metrics_tpu/functional/regression``)."""

from metrics_tpu_torch.functional.regression.basic import (
    log_cosh_error,
    mean_absolute_error,
    mean_absolute_percentage_error,
    mean_squared_error,
    mean_squared_log_error,
    symmetric_mean_absolute_percentage_error,
    weighted_mean_absolute_percentage_error,
)
from metrics_tpu_torch.functional.regression.misc import (
    cosine_similarity,
    kendall_rank_corrcoef,
    kl_divergence,
    spearman_corrcoef,
    tweedie_deviance_score,
)
from metrics_tpu_torch.functional.regression.moments import (
    concordance_corrcoef,
    explained_variance,
    pearson_corrcoef,
    r2_score,
)

__all__ = [
    "concordance_corrcoef",
    "cosine_similarity",
    "explained_variance",
    "kendall_rank_corrcoef",
    "kl_divergence",
    "log_cosh_error",
    "mean_absolute_error",
    "mean_absolute_percentage_error",
    "mean_squared_error",
    "mean_squared_log_error",
    "pearson_corrcoef",
    "r2_score",
    "spearman_corrcoef",
    "symmetric_mean_absolute_percentage_error",
    "tweedie_deviance_score",
    "weighted_mean_absolute_percentage_error",
]
