"""Stat-scores (tp/fp/tn/fn): binary, multiclass and multilabel, and the
``stat_scores`` task façade (port of
``metrics_tpu/functional/classification/stat_scores.py``).

``ignore_index`` is a 0-weight mask rather than boolean filtering, as in the
JAX package, so no state's shape depends on the values. Every count is int32,
as there (x64 off): torch's integer sums return int64, so each sum is asked
for int32. Labels count by their low 32 bits, as the JAX package sees int64
input, and bool labels as 0/1.

The binary and multilabel updates are masked products and sums, plain torch
code as the JAX package's are plain jnp (no kernel of the JAX package lies on
them). Float predictions go through a sigmoid when any value lies outside
[0, 1], decided on the device, then ``> threshold`` in their own dtype.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.kernels import confmat
from metrics_tpu_torch.utils.checks import _check_same_shape, _value_check_possible
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


def _label32(x: Tensor) -> Tensor:
    """Integer or bool labels as int32 (the low 32 bits, as the JAX package sees them)."""
    return x if x.dtype == torch.int32 else x.to(torch.int32)


def _check_binary_values(target: Tensor, ignore_index: Optional[int]) -> None:
    """The values check of binary and multilabel targets, skipped where values
    cannot be read (one host read of the unique values)."""
    if _value_check_possible(target):
        unique_values = set(torch.unique(_label32(target)).tolist())
        allowed = {0, 1} if ignore_index is None else {0, 1, ignore_index}
        if not unique_values.issubset(allowed):
            raise RuntimeError(
                f"Detected the following values in `target`: {sorted(unique_values)} but expected only"
                f" the following values {sorted(allowed)}."
            )


def _threshold_format(preds: Tensor, target: Tensor, threshold: float, ignore_index: Optional[int]
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """int32 0/1 preds (float preds thresholded, through a sigmoid if they are
    logits), int32 target with ignored positions zeroed, and the keep mask."""
    if preds.is_floating_point():
        preds = (_sigmoid_if_logits(preds) > threshold).to(torch.int32)
    else:
        preds = _label32(preds)
    target = _label32(target)
    mask = _ignore_mask(target, ignore_index)
    return torch.where(mask, preds, 0), torch.where(mask, target, 0), mask


def _empty_batch_check(preds: Tensor) -> None:
    if preds.shape[0] == 0:
        # jnp.reshape(x, (0, -1)) in the JAX package raises ZeroDivisionError; the port raises the same type
        raise ZeroDivisionError("An empty batch cannot be flattened to (N, -1): the size of -1 is ambiguous.")


def _binary_stat_scores_arg_validation(
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    allowed_multidim_average = ("global", "samplewise")
    if multidim_average not in allowed_multidim_average:
        raise ValueError(
            f"Expected argument `multidim_average` to be one of {allowed_multidim_average}, but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_stat_scores_tensor_validation(
    preds: Tensor,
    target: Tensor,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    _check_same_shape(preds, target)
    if target.is_floating_point():
        raise ValueError("Expected argument `target` to be an int or bool tensor, but got a float tensor.")
    _check_binary_values(target, ignore_index)
    if not preds.is_floating_point() and _value_check_possible(preds):
        unique_values = set(torch.unique(_label32(preds)).tolist())
        if not unique_values.issubset({0, 1}):
            raise RuntimeError(
                f"Detected the following values in `preds`: {sorted(unique_values)} but expected only"
                " the following values [0,1] since preds is a label tensor."
            )
    if multidim_average != "global" and preds.ndim < 2:
        raise ValueError("Expected input to be at least 2D when multidim_average is set to `samplewise`")


def _binary_stat_scores_format(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Flattened ``(N, X)`` int32 0/1 preds and target and the keep mask."""
    _empty_batch_check(preds)
    preds, target, mask = _threshold_format(preds, target, threshold, ignore_index)
    n = preds.shape[0]
    return preds.reshape(n, -1), target.reshape(n, -1), mask.reshape(n, -1)


def _masked_counts(preds: Tensor, target: Tensor, mask: Tensor, dim: Any) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """int32 tp/fp/tn/fn: the masked products summed over ``dim`` (None: all)."""
    m = mask.to(torch.int32)

    def count(prod: Tensor) -> Tensor:
        return prod.sum(dtype=torch.int32) if dim is None else prod.sum(dim=dim, dtype=torch.int32)

    tp = count(preds * target * m)
    fn = count((1 - preds) * target * m)
    fp = count(preds * (1 - target) * m)
    tn = count((1 - preds) * (1 - target) * m)
    return tp, fp, tn, fn


def _binary_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    mask: Tensor,
    multidim_average: str = "global",
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """int32 tp/fp/tn/fn: scalars for global, ``(N,)`` for samplewise."""
    return _masked_counts(preds, target, mask, None if multidim_average == "global" else 1)


def _binary_stat_scores_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, multidim_average: str = "global"
) -> Tensor:
    """Stacked ``[tp, fp, tn, fn, support]``."""
    return torch.stack([tp, fp, tn, fn, tp + fn], dim=0 if multidim_average == "global" else 1)


def binary_stat_scores(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """tp/fp/tn/fn/support for binary tasks.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional.classification import binary_stat_scores
        >>> binary_stat_scores(torch.tensor([0, 0, 1, 1, 0, 1]), torch.tensor([0, 1, 0, 1, 0, 1]))
        tensor([2, 1, 2, 1, 3], dtype=torch.int32)
    """
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, multidim_average, ignore_index)
    preds, target, mask = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    tp, fp, tn, fn = _binary_stat_scores_update(preds, target, mask, multidim_average)
    return _binary_stat_scores_compute(tp, fp, tn, fn, multidim_average)


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
        return confmat.stat_scores(target.reshape(-1), preds.reshape(-1), num_classes, ignore_index)

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


def _multilabel_stat_scores_arg_validation(
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float, but got {threshold}.")
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


def _multilabel_stat_scores_tensor_validation(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    _check_same_shape(preds, target)
    if preds.shape[1] != num_labels:
        raise ValueError(
            "Expected both `target.shape[1]` and `preds.shape[1]` to be equal to the number of labels"
        )
    if target.is_floating_point():
        raise ValueError("Expected argument `target` to be an int or bool tensor, but got a float tensor.")
    _check_binary_values(target, ignore_index)
    if multidim_average != "global" and preds.ndim < 3:
        raise ValueError("Expected input to be at least 3D when multidim_average is set to `samplewise`")


def _multilabel_stat_scores_format(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """``(N, C, X)`` int32 0/1 preds and target and the keep mask."""
    _empty_batch_check(preds)
    preds, target, mask = _threshold_format(preds, target, threshold, ignore_index)
    shape = (preds.shape[0], preds.shape[1], -1)
    return preds.reshape(shape), target.reshape(shape), mask.reshape(shape)


def _multilabel_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    mask: Tensor,
    multidim_average: str = "global",
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """int32 tp/fp/tn/fn: ``(C,)`` for global, ``(N, C)`` for samplewise."""
    return _masked_counts(preds, target, mask, (0, 2) if multidim_average == "global" else (2,))


def _multilabel_stat_scores_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, average: Optional[str] = "macro", multidim_average: str = "global"
) -> Tensor:
    res = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    if average == "micro":
        return res.sum(dim=-2, dtype=res.dtype)
    return res


def multilabel_stat_scores(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """tp/fp/tn/fn/support for multilabel tasks.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional.classification import multilabel_stat_scores
        >>> multilabel_stat_scores(torch.tensor([[1, 0, 1], [0, 1, 0]]), torch.tensor([[1, 0, 0], [0, 1, 1]]), 3)
        tensor([[1, 0, 1, 0, 1],
                [1, 0, 1, 0, 1],
                [0, 1, 0, 1, 1]], dtype=torch.int32)
    """
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target, mask = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    tp, fp, tn, fn = _multilabel_stat_scores_update(preds, target, mask, multidim_average)
    return _multilabel_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)


def _task_error(task: str) -> ValueError:
    return ValueError(f"Expected argument `task` to either be 'binary', 'multiclass' or 'multilabel' but got {task}")


def stat_scores(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
    top_k: int = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatch façade over the binary, multiclass and multilabel stat scores.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import stat_scores
        >>> stat_scores(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]), task="multiclass", num_classes=3)
        tensor([3, 1, 7, 1, 4], dtype=torch.int32)
    """
    task = str(task).lower()
    if task == "binary":
        return binary_stat_scores(preds, target, threshold, multidim_average, ignore_index, validate_args)
    if task == "multiclass":
        assert isinstance(num_classes, int)
        return multiclass_stat_scores(
            preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
        )
    if task == "multilabel":
        assert isinstance(num_labels, int)
        return multilabel_stat_scores(
            preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
        )
    raise _task_error(task)
