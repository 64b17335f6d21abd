"""Stat-scores (tp/fp/tn/fn), multiclass part
(port of ``metrics_tpu/functional/classification/stat_scores.py:185-404``).

``ignore_index`` is a 0-weight mask rather than boolean filtering, as in the
JAX package. Every count is int32, as there (x64 off): torch's integer sums
return int64, so each count is cast back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.kernels.confmat import stat_scores
from metrics_tpu_torch.utils.checks import _value_check_possible
from metrics_tpu_torch.utils.data import _one_hot, select_topk


def _sigmoid_if_logits(preds: Tensor) -> Tensor:
    """Sigmoid iff any value lies outside [0, 1], chosen on the device (no host sync)."""
    return torch.where(torch.any((preds < 0) | (preds > 1)), torch.sigmoid(preds), preds)


def _softmax_if_logits(preds: Tensor, dim: int = 1) -> Tensor:
    """Softmax along ``dim`` iff the values do not already sum to 1 there (as
    ``jnp.allclose(sums, 1.0, atol=1e-4)`` decides), chosen on the device."""
    sums_to_one = torch.all(torch.abs(torch.sum(preds, dim=dim) - 1.0) <= 1e-4 + 1e-5)
    return torch.where(sums_to_one, preds, torch.softmax(preds, dim=dim))


def _ignore_mask(target: Tensor, ignore_index: Optional[int]) -> Tensor:
    """Boolean weight mask that zeroes out ignored positions."""
    if ignore_index is None:
        return torch.ones_like(target, dtype=torch.bool)
    return target != ignore_index


def _multiclass_stat_scores_arg_validation(
    num_classes: int,
    top_k: int = 1,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if not isinstance(top_k, int) or top_k < 1:
        raise ValueError(f"Expected argument `top_k` to be an integer larger than or equal to 1, but got {top_k}")
    if top_k > num_classes:
        raise ValueError(
            f"Expected argument `top_k` to be smaller or equal to `num_classes` but got {top_k} and {num_classes}"
        )
    allowed_average = ("micro", "macro", "weighted", "none", None)
    if average not in allowed_average:
        raise ValueError(f"Expected argument `average` to be one of {allowed_average}, but got {average}")
    allowed_multidim_average = ("global", "samplewise")
    if multidim_average not in allowed_multidim_average:
        raise ValueError(
            f"Expected argument `multidim_average` to be one of {allowed_multidim_average}, but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _multiclass_stat_scores_tensor_validation(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if preds.ndim == target.ndim + 1:
        if not preds.is_floating_point():
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[1] != num_classes:
            raise ValueError("If `preds` have one dimension more than `target`, `preds.shape[1]` should be"
                             " equal to number of classes.")
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError("If `preds` have one dimension more than `target`, the shape of `preds` should be"
                             " (N, C, ...), and the shape of `target` should be (N, ...).")
        if multidim_average != "global" and preds.ndim < 3:
            raise ValueError("If `preds` have one dimension more than `target`, the shape of `preds` should "
                             "at least be of shape (N, C, ...) when multidim_average is set to `samplewise`")
    elif preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError("The `preds` and `target` should have the same shape,"
                             f" got `preds` with shape={preds.shape} and `target` with shape={target.shape}.")
        if multidim_average != "global" and preds.ndim < 2:
            raise ValueError("When `preds` and `target` have the same shape, the shape should be (N, ...) with at"
                             " least 2 dimensions when multidim_average is set to `samplewise`")
        if preds.is_floating_point():
            raise ValueError("If `preds` and `target` have the same shape, `preds` should be an int tensor.")
    else:
        raise ValueError("Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be"
                         " (N, ...) and `preds` should be (N, C, ...).")

    if _value_check_possible(target):
        if ignore_index is None and target.numel() == 0:
            # the JAX package's check takes the minimum of the empty target, which raises ValueError
            raise ValueError("Expected a non-empty `target`: an empty batch has no minimum to check against 0.")
        num_unique = max(int(target.max()), 0) + 1 if target.numel() else 1
        check = num_unique > (num_classes if ignore_index is None else num_classes + 1)
        if (ignore_index is None and int(target.min()) < 0) or check:
            raise RuntimeError(f"Detected more unique values in `target` than `num_classes`. Expected only up to"
                               f" {num_classes} but found up to {num_unique}.")
    if _value_check_possible(preds) and not preds.is_floating_point():
        if (max(int(preds.max()), 0) if preds.numel() else 0) + 1 > num_classes:
            raise RuntimeError("Detected more unique values in `preds` than `num_classes`.")


def _multiclass_stat_scores_format(preds: Tensor, target: Tensor, top_k: int = 1) -> Tuple[Tensor, Tensor]:
    """Flatten extra dims: preds ``(N, C, X)`` probs (or ``(N, X)`` labels), target ``(N, X)``.

    An empty batch raises ZeroDivisionError, as ``jnp.reshape(x, (0, -1))``
    does in the JAX package (an accident of its shape arithmetic that the port
    copies, so that both packages raise the same type).
    """
    if preds.shape[0] == 0:
        raise ZeroDivisionError("An empty batch cannot be flattened to (N, -1): the size of -1 is ambiguous.")
    if preds.is_floating_point():
        if top_k == 1:
            preds = torch.argmax(preds, dim=1)
            preds = preds.reshape(preds.shape[0], -1)
        else:
            preds = preds.reshape(preds.shape[0], preds.shape[1], -1)
    else:
        preds = preds.reshape(preds.shape[0], -1)
    target = target.reshape(target.shape[0], -1)
    return preds, target


def _multiclass_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    top_k: int = 1,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-class int32 tp/fp/tn/fn. Output shapes: global ``(C,)``; samplewise ``(N, C)``.

    With label preds and a global reduce, every count is what the (C, C)
    confusion matrix gives (the JAX package's route on its CPU backend and for
    matmul-eligible sizes on accelerators): the kernel plane's ``stat_scores``,
    whose CUDA route counts tp/fp/fn per class and the valid pairs without
    building the table, and whose plain version (CPU) derives them from the
    bincount pair count. The labels go to it as they are. The rest
    (samplewise, or top_k > 1 probs) is one-hot arithmetic.
    """
    if multidim_average == "global" and preds.ndim != 3:
        return stat_scores(target.reshape(-1), preds.reshape(-1), num_classes, ignore_index)

    target = target.to(torch.int32)  # labels count by their low 32 bits, as the JAX package sees them
    mask = _ignore_mask(target, ignore_index)
    target_ = torch.where(mask, target, 0).to(torch.int32)
    m = mask.to(torch.float32)
    # Out-of-range indices (reachable only with validate_args=False) drop the
    # whole PAIR, exactly like the confusion-matrix route above.
    if preds.ndim != 3:
        preds = preds.to(torch.int32)
        m = m * ((preds >= 0) & (preds < num_classes)).to(torch.float32)
    m = m * ((target_ >= 0) & (target_ < num_classes)).to(torch.float32)
    m_ = m.unsqueeze(-1)

    oh_target = _one_hot(target_, num_classes, torch.float32) * m_  # (N, X, C)
    if preds.ndim == 3:  # (N, C, X) probs with top_k > 1
        topk_mask = select_topk(preds, top_k, dim=1)
        oh_preds = torch.movedim(topk_mask, 1, -1).to(torch.float32) * m_
    else:
        oh_preds = _one_hot(preds, num_classes, torch.float32) * m_

    sum_axes = (0, 1) if multidim_average == "global" else (1,)

    def _count(prod: Tensor) -> Tensor:
        return prod.to(torch.int32).sum(dim=sum_axes, dtype=torch.int32)

    tp = _count(oh_preds * oh_target)
    fp = _count(oh_preds * (1.0 - oh_target))
    fn = _count((1.0 - oh_preds) * oh_target)
    # tn must only count non-ignored positions: scale by mask
    tn = _count((1.0 - oh_preds) * (1.0 - oh_target) * m_)
    return tp, fp, tn, fn


def _multiclass_stat_scores_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, average: Optional[str] = "macro", multidim_average: str = "global"
) -> Tensor:
    res = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    if average == "micro":
        return res.sum(dim=-2, dtype=res.dtype)
    return res


def multiclass_stat_scores(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """tp/fp/tn/fn/support for multiclass tasks."""
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    preds, target = _multiclass_stat_scores_format(preds, target, top_k)
    tp, fp, tn, fn = _multiclass_stat_scores_update(
        preds, target, num_classes, top_k, average, multidim_average, ignore_index
    )
    return _multiclass_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)
