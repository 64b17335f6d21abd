"""Confusion-matrix functionals, multiclass part
(port of ``metrics_tpu/functional/classification/confusion_matrix.py``).

The multiclass count is the kernel plane's pair count
(:mod:`metrics_tpu_torch.kernels.confmat`): the CUDA kernel on CUDA tensors,
the bincount reference on CPU tensors. Rows are the true class, columns the
predicted class; ignored pairs and out-of-range class
indices (reachable only with ``validate_args=False``) are dropped. Labels count
by their low 32 bits, as the JAX package sees them with x64 off.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.stat_scores import (
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
)
from metrics_tpu_torch.kernels.confmat import pair_count
from metrics_tpu_torch.utils.compute import _safe_divide


def _confusion_matrix_reduce(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    """Normalise over true/pred/all; counts stay int32 when ``normalize`` is None/"none"."""
    allowed_normalize = ("true", "pred", "all", "none", None)
    if normalize not in allowed_normalize:
        raise ValueError(f"Argument `normalize` needs to one of the following: {allowed_normalize}")
    if normalize is not None and normalize != "none":
        confmat = confmat.to(torch.float32)
        if normalize == "true":
            confmat = _safe_divide(confmat, confmat.sum(dim=-1, keepdim=True))
        elif normalize == "pred":
            confmat = _safe_divide(confmat, confmat.sum(dim=-2, keepdim=True))
        elif normalize == "all":
            confmat = _safe_divide(confmat, confmat.sum(dim=(-2, -1), keepdim=True))
    return confmat


def _multiclass_confusion_matrix_update(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> Tensor:
    """(C, C) int32 counts, rows = true class, by one pair count. The labels
    go to it as they are (the kernel reads int32 and int64), and so does
    ``ignore_index``, which it compares with the target's low 32 bits."""
    return pair_count(target.reshape(-1), preds.reshape(-1), num_classes, num_classes, ignore_index=ignore_index)


def multiclass_confusion_matrix(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
    normalize: Optional[str] = None,
    validate_args: bool = True,
) -> Tensor:
    if validate_args:
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, "global", ignore_index)
    preds, target = _multiclass_stat_scores_format(preds, target, top_k=1)
    confmat = _multiclass_confusion_matrix_update(preds, target, num_classes, ignore_index)
    return _confusion_matrix_reduce(confmat, normalize)
