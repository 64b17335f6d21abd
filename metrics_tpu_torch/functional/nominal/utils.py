"""Shared helpers of the nominal association metrics (port of
``metrics_tpu/functional/nominal/utils.py``): argument checks, NaN handling,
bias-corrected dimensions, the dropping of empty rows and columns, and the
contingency table of two label vectors.

The table is the table route of the pair count
(``metrics_tpu_torch/kernels/confmat.py``): ``csrc/pair_count.cu`` on a CUDA
tensor, one launch a table, the plain bincount on a CPU tensor. A pair with a
negative or out-of-range label on either side (reachable through a
``nan_replace_value`` of -1) is dropped, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.kernels import confmat as _confmat
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _nominal_input_validation(nan_strategy: str, nan_replace_value: Optional[float]) -> None:
    if nan_strategy not in ["replace", "drop"]:
        raise ValueError(
            f"Argument `nan_strategy` is expected to be one of `['replace', 'drop']`, but got {nan_strategy}"
        )
    if nan_strategy == "replace" and not isinstance(nan_replace_value, (int, float)):
        raise ValueError(
            "Argument `nan_replace` is expected to be of a type `int` or `float` when `nan_strategy = 'replace`, "
            f"but got {nan_replace_value}"
        )


def _handle_nan_in_data(
    preds: Tensor,
    target: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tuple[Tensor, Tensor]:
    """Replace NaNs by ``nan_replace_value``, or drop every pair with a NaN on
    either side (a data-dependent shape: one host sync)."""
    if nan_strategy == "replace":
        return (
            torch.where(torch.isnan(preds), nan_replace_value, preds),
            torch.where(torch.isnan(target), nan_replace_value, target),
        )
    keep = ~(torch.isnan(preds) | torch.isnan(target))
    return preds[keep], target[keep]


def _compute_bias_corrected_dims(confmat: Tensor) -> Tuple[Tensor, Tensor]:
    """Bias-corrected numbers of rows and columns, float32."""
    confmat = confmat.to(torch.float32)
    n = torch.sum(confmat)
    r, k = confmat.shape
    r_corrected = r - (r - 1) ** 2 / (n - 1)
    k_corrected = k - (k - 1) ** 2 / (n - 1)
    return r_corrected, k_corrected


def _drop_empty_rows_and_cols(confmat: Tensor) -> Tensor:
    """The table without its all-zero rows and columns (a data-dependent shape:
    one host sync on the card)."""
    return confmat[confmat.sum(1) != 0][:, confmat.sum(0) != 0]


def _unable_to_compute_warning(metric: str) -> None:
    rank_zero_warn(
        f"Unable to compute {metric} because the data does not allow it. Returning NaN.",
        UserWarning,
    )


def _joint_confusion_matrix(preds: Tensor, target: Tensor, num_classes_preds: int, num_classes_target: int) -> Tensor:
    """(Cx, Cy) int32 contingency counts, rows the categories of ``preds``."""
    return _confmat.pair_count(preds.reshape(-1), target.reshape(-1), num_classes_preds, num_classes_target)
