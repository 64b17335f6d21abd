"""Shared stat-scores pipeline (validate, format, update) used by the derived
classification metrics (port of ``metrics_tpu/functional/classification/_pipeline.py``,
multiclass part)."""

from __future__ import annotations

from typing import Optional, Tuple

from torch import Tensor

from metrics_tpu_torch.functional.classification.stat_scores import (
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multiclass_stat_scores_update,
)

StatScores = Tuple[Tensor, Tensor, Tensor, Tensor]


def multiclass_pipeline(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> StatScores:
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    preds, target = _multiclass_stat_scores_format(preds, target, top_k)
    return _multiclass_stat_scores_update(preds, target, num_classes, top_k, average, multidim_average, ignore_index)
