"""Precision-recall curve functionals, the two state regimes
(port of ``metrics_tpu/functional/classification/precision_recall_curve.py``).

Binned mode (``thresholds`` given): a fixed-shape int32 ``(T, 2, 2)`` (or
``(T, C, 2, 2)``) confusion state per threshold, from the threshold counts of
:func:`metrics_tpu_torch.kernels.binned_curve.binned_curve_counts`: the CUDA
kernel for tensors on the GPU, its plain comparison version for tensors on
the CPU. The route follows the tensor's device. The JAX package takes a
bucketize + histogram route on its CPU backend instead, which counts a NaN
score as above every threshold; the port counts it as above none on both
devices, as the JAX kernel and its comparison reference do.

Exact mode (``thresholds=None``): ragged value lists, computed by a stable
sort and a cumulative sum.

``thresholds=int`` becomes ``T`` evenly spaced float32 values in [0, 1] built
as ``jnp.linspace`` builds them, bit for bit (``torch.linspace`` differs from
it in the last bit at some positions, which moves a score lying between the
two values to another threshold).
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.stat_scores import (
    _ignore_mask,
    _sigmoid_if_logits,
    _softmax_if_logits,
)
from metrics_tpu_torch.kernels.binned_curve import binned_curve_counts
from metrics_tpu_torch.utils.checks import _check_same_shape, _value_check_possible
from metrics_tpu_torch.utils.compute import _safe_divide
from metrics_tpu_torch.utils.data import _one_hot

Thresholds = Optional[Union[int, List[float], Tensor]]

# Exact-mode ignore marker: formatted preds are probabilities in [0, 1]
# (sigmoid/softmax applied in the *_format helpers), so -1 can never collide
# with a real score.
_EXACT_IGNORE_SENTINEL = -1.0


def _linspace01(steps: int, device: Optional[torch.device] = None, dtype: torch.dtype = torch.float32) -> Tensor:
    """``jnp.linspace(0, 1, steps, dtype=dtype)`` bit for bit (float32 and float16):
    ``i * (1 / (steps - 1))`` in ``dtype``, with the last value set to exactly 1."""
    if steps == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    step = torch.tensor(1.0, dtype=dtype) / (steps - 1)
    out = torch.arange(steps, dtype=dtype) * step
    out[-1] = 1.0
    return out.to(device)


def _adjust_threshold_arg(thresholds: Thresholds = None, device: Optional[torch.device] = None) -> Optional[Tensor]:
    """Normalise the thresholds argument: ``None`` stays, an int becomes evenly
    spaced values in [0, 1], a list or tensor becomes float32 on ``device``."""
    if isinstance(thresholds, int):
        return _linspace01(thresholds, device)
    if isinstance(thresholds, (list, tuple)):
        return torch.tensor(thresholds, dtype=torch.float32, device=device)
    if thresholds is not None:
        thresholds = torch.as_tensor(thresholds).to(device=device, dtype=torch.float32)
        if thresholds.ndim > 1:  # the JAX package's searchsorted raises ValueError on it
            raise ValueError(f"Expected `thresholds` to be 1-dimensional, got shape {tuple(thresholds.shape)}.")
        return thresholds
    return None


def _binary_clf_curve(preds: Tensor, target: Tensor, pos_label: int = 1) -> Tuple[Tensor, Tensor, Tensor]:
    """fps/tps/thresholds by a descending-score cumulative sum.

    Tied scores collapse into one threshold point (the cumulative count at
    the end of each run). The order is the reverse of a stable ascending
    sort, as the JAX package's ``argsort(preds)[::-1]``. The output length
    depends on the data. ``preds`` went through the ``*_format`` helpers
    (probabilities in [0, 1]), so rows marked with ``_EXACT_IGNORE_SENTINEL``
    are ignored rows and are dropped.
    """
    keep = preds != _EXACT_IGNORE_SENTINEL
    if not bool(keep.all()):
        preds, target = preds[keep], target[keep]
    if preds.shape[0] == 0:
        # the JAX package's gather of the last index raises TypeError here (an
        # accident of its code that the port copies, so both raise the same type)
        raise TypeError("An exact-mode curve needs at least one score that is not ignored, got none.")
    order = torch.argsort(preds, stable=True).flip(0)
    preds = preds[order]
    target = (target[order] == pos_label).to(torch.float32)
    tps = torch.cumsum(target, dim=0)
    fps = torch.cumsum(1 - target, dim=0)

    distinct_idx = torch.nonzero(torch.diff(preds))[:, 0]
    last = torch.tensor([preds.shape[0] - 1], dtype=distinct_idx.dtype, device=preds.device)
    threshold_idxs = torch.cat([distinct_idx, last])
    return fps[threshold_idxs], tps[threshold_idxs], preds[threshold_idxs]


def _exact_mode_filter(preds: Tensor, target: Tensor, thresholds: Optional[Tensor], ignore_index: Optional[int],
                       mask: Tensor) -> Tuple[Tensor, Tensor]:
    """Apply ``ignore_index`` in exact mode.

    Eagerly the ignored rows are filtered out. Where values cannot be read
    (``torch.compile`` tracing) they stay, at static shape, with their score
    set to ``_EXACT_IGNORE_SENTINEL`` and their target to 0, and the exact
    compute drops them. For 2-D ``preds`` an (N,) mask ignores whole rows.
    """
    if thresholds is None and ignore_index is not None:
        if not _value_check_possible(mask):
            row_mask = mask[:, None] if preds.ndim == 2 and mask.ndim == 1 else mask
            preds = torch.where(row_mask, preds, _EXACT_IGNORE_SENTINEL)
            return preds, torch.where(mask, target, 0)
        return preds[mask], target[mask]
    return preds, target


def _exact_target_for_weights(state: Tuple[Tensor, ...]) -> Tensor:
    """The target rows of an exact-mode state without sentinel rows (for the
    ``average="weighted"`` class counts)."""
    preds, target = state[0], state[1]
    col = preds[:, 0] if preds.ndim == 2 else preds
    keep = col != _EXACT_IGNORE_SENTINEL
    if not bool(keep.all()):
        target = target[keep]
    return target


def _binary_precision_recall_curve_arg_validation(
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    if thresholds is not None and not isinstance(thresholds, (list, int, Tensor)) and not hasattr(thresholds, "__len__"):
        raise ValueError(
            "Expected argument `thresholds` to either be an integer, list of floats or tensor of floats,"
            f" but got {thresholds}"
        )
    if isinstance(thresholds, int) and thresholds < 2:
        raise ValueError(f"If argument `thresholds` is an integer, expected it to be larger than 1, but got {thresholds}")
    if isinstance(thresholds, list) and not all(isinstance(t, float) and 0 <= t <= 1 for t in thresholds):
        raise ValueError(
            f"If argument `thresholds` is a list, expected all elements to be floats in the [0,1] range, but got {thresholds}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_precision_recall_curve_tensor_validation(
    preds: Tensor, target: Tensor, ignore_index: Optional[int] = None
) -> None:
    _check_same_shape(preds, target)
    if not preds.is_floating_point():
        raise ValueError("Expected argument `preds` to be an floating tensor, but got tensor with dtype"
                         f" {preds.dtype}")
    if target.is_floating_point():
        raise ValueError("Expected argument `target` to be an int or bool tensor, but got tensor with dtype"
                         f" {target.dtype}")
    if _value_check_possible(target):
        unique_values = set(torch.unique(target).tolist())
        allowed = {0, 1} if ignore_index is None else {0, 1, ignore_index}
        if not unique_values.issubset(allowed):
            raise RuntimeError(
                f"Detected the following values in `target`: {sorted(unique_values)} but expected only"
                f" the following values {sorted(allowed)}."
            )


def _binary_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor], Tensor]:
    """Flatten and sigmoid-if-logits; ``(preds, target, thresholds, weight mask)``.
    ``ignore_index`` gives a 0/1 mask rather than a filter, so shapes stay static."""
    preds = preds.reshape(-1)
    target = target.reshape(-1)
    mask = _ignore_mask(target, ignore_index).reshape(-1)
    target = torch.where(mask, target, 0)
    preds = _sigmoid_if_logits(preds)
    thresholds = _adjust_threshold_arg(thresholds, preds.device)
    return preds, target, thresholds, mask


def _confmat_from_counts(tp: Tensor, fp: Tensor, pos: Tensor, neg: Tensor) -> Tensor:
    """The int32 ``[[tn, fp], [fn, tp]]`` state from float32 counts, as the JAX
    package forms it (float32 differences, then the cast)."""
    fn = pos - tp
    tn = neg - fp
    confmat = torch.stack([torch.stack([tn, fp], dim=-1), torch.stack([fn, tp], dim=-1)], dim=-2)
    return confmat.to(torch.int32)


def _binary_precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    thresholds: Optional[Tensor],
    mask: Optional[Tensor] = None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Binned: the int32 ``(T, 2, 2)`` state, one kernel launch on the GPU."""
    if thresholds is None:
        return preds, target
    len_t = thresholds.shape[0]
    preds = preds.to(torch.float32)
    w = mask.to(torch.float32) if mask is not None else torch.ones_like(preds)
    t = target.to(torch.float32) * w
    pos = torch.sum(t)
    neg = torch.sum(w) - pos
    tp, fp = binned_curve_counts(preds, t, w, thresholds)
    return _confmat_from_counts(tp, fp, pos, neg).reshape(len_t, 2, 2)


def _binary_precision_recall_curve_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    thresholds: Optional[Tensor],
    pos_label: int = 1,
) -> Tuple[Tensor, Tensor, Tensor]:
    if isinstance(state, Tensor) and thresholds is not None:
        tps = state[:, 1, 1]
        fps = state[:, 0, 1]
        fns = state[:, 1, 0]
        precision = _safe_divide(tps, tps + fps)
        recall = _safe_divide(tps, tps + fns)
        precision = torch.cat([precision, torch.ones(1, dtype=precision.dtype, device=precision.device)])
        recall = torch.cat([recall, torch.zeros(1, dtype=recall.dtype, device=recall.device)])
        return precision, recall, thresholds

    preds, target = state
    fps, tps, thresh = _binary_clf_curve(preds, target, pos_label=pos_label)
    # plain division: with no positives the exact regime gives NaN recall
    # (tps + fps >= 1 at every observed threshold, so precision never does)
    precision = tps / (tps + fps)
    recall = tps / tps[-1]

    # stop when full recall is reached, and reverse so that recall does not increase
    last_ind = int(torch.argmax((tps >= tps[-1]).to(torch.int32)))
    sl = slice(0, last_ind + 1)
    precision = torch.cat([precision[sl].flip(0), torch.ones(1, dtype=precision.dtype, device=precision.device)])
    recall = torch.cat([recall[sl].flip(0), torch.zeros(1, dtype=recall.dtype, device=recall.device)])
    thresh = thresh[sl].flip(0)
    return precision, recall, thresh


def binary_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Precision-recall pairs at each threshold for binary tasks.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import binary_precision_recall_curve
        >>> preds = torch.tensor([0.1, 0.6, 0.8, 0.4])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> precision, recall, thresholds = binary_precision_recall_curve(preds, target, thresholds=4)
        >>> precision
        tensor([0.5000, 0.6667, 1.0000, 0.0000, 1.0000])
    """
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds, mask = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    if thresholds is None and ignore_index is not None:
        preds, target = _exact_mode_filter(preds, target, thresholds, ignore_index, mask)
        mask = None
    state = _binary_precision_recall_curve_update(preds, target, thresholds, mask)
    return _binary_precision_recall_curve_compute(state, thresholds)


# --------------------------------------------------------------------------- multiclass


def _multiclass_precision_recall_curve_arg_validation(
    num_classes: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)


def _multiclass_precision_recall_curve_tensor_validation(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    if preds.ndim != target.ndim + 1:
        raise ValueError(
            f"Expected `preds` to have one more dimension than `target` but got {preds.ndim} and {target.ndim}"
        )
    if not preds.is_floating_point():
        raise ValueError(f"Expected `preds` to be a float tensor, but got {preds.dtype}")
    if target.is_floating_point():
        raise ValueError(f"Expected argument `target` to be an int or bool tensor, but got {target.dtype}")
    if preds.shape[1] != num_classes:
        raise ValueError(f"Expected `preds.shape[1]={preds.shape[1]}` to be equal to the number of classes")
    if preds.shape[0] != target.shape[0] or preds.shape[2:] != target.shape[1:]:
        raise ValueError(
            "Expected the shape of `preds` should be (N, C, ...) and the shape of `target` should be (N, ...)."
        )
    if _value_check_possible(target):
        num_unique = max(int(torch.max(target)) if target.numel() else 0, 0) + 1
        if num_unique > (num_classes if ignore_index is None else num_classes + 1):
            raise RuntimeError("Detected more unique values in `target` than `num_classes`.")


def _multiclass_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor], Tensor]:
    preds = torch.movedim(preds, 1, -1).reshape(-1, num_classes)
    target = target.reshape(-1)
    mask = _ignore_mask(target, ignore_index)
    target = torch.where(mask, target, 0)
    preds = _softmax_if_logits(preds, dim=-1)
    thresholds = _adjust_threshold_arg(thresholds, preds.device)
    return preds, target, thresholds, mask


def _multiclass_precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Optional[Tensor],
    mask: Optional[Tensor] = None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Binned: the int32 ``(T, C, 2, 2)`` one-vs-rest state. The counts are
    one kernel launch over all C columns, with the row mask as a per-row
    weight; no ``(T, M, C)`` comparison is formed."""
    if thresholds is None:
        return preds, target
    len_t = thresholds.shape[0]
    preds = preds.to(torch.float32)
    w = mask.to(torch.float32) if mask is not None else torch.ones(target.shape, dtype=torch.float32, device=preds.device)
    oh_target = _one_hot(target, num_classes, torch.float32) * w[:, None]  # (M, C)
    pos = torch.sum(oh_target, dim=0)  # (C,)
    total = torch.sum(w)
    tp, fp = binned_curve_counts(preds, oh_target, w, thresholds)
    return _confmat_from_counts(tp, fp, pos[None, :], (total - pos)[None, :]).reshape(len_t, num_classes, 2, 2)


def _multiclass_precision_recall_curve_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_classes: int,
    thresholds: Optional[Tensor],
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    if isinstance(state, Tensor) and thresholds is not None:
        tps = state[:, :, 1, 1]
        fps = state[:, :, 0, 1]
        fns = state[:, :, 1, 0]
        precision = _safe_divide(tps, tps + fps)
        recall = _safe_divide(tps, tps + fns)
        ones = torch.ones((1, num_classes), dtype=precision.dtype, device=precision.device)
        precision = torch.cat([precision, ones], dim=0).T
        recall = torch.cat([recall, torch.zeros_like(ones)], dim=0).T
        return precision, recall, thresholds

    preds, target = state
    precision_list, recall_list, thresh_list = [], [], []
    for i in range(num_classes):
        res = _binary_precision_recall_curve_compute((preds[:, i], (target == i).to(torch.int32)), None, pos_label=1)
        precision_list.append(res[0])
        recall_list.append(res[1])
        thresh_list.append(res[2])
    return precision_list, recall_list, thresh_list


def multiclass_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds, mask = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    if thresholds is None and ignore_index is not None:
        preds, target = _exact_mode_filter(preds, target, thresholds, ignore_index, mask)
        mask = None
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, mask)
    return _multiclass_precision_recall_curve_compute(state, num_classes, thresholds)


# --------------------------------------------------------------------------- multilabel


def _multilabel_precision_recall_curve_arg_validation(
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _multiclass_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)


def _multilabel_precision_recall_curve_tensor_validation(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    _check_same_shape(preds, target)
    if preds.shape[1] != num_labels:
        raise ValueError("Expected `preds.shape[1]` to be equal to the number of labels")
    if not preds.is_floating_point():
        raise ValueError(f"Expected `preds` to be a float tensor, but got {preds.dtype}")


def _multilabel_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor], Tensor]:
    preds = torch.movedim(preds, 1, -1).reshape(-1, num_labels)
    target = torch.movedim(target, 1, -1).reshape(-1, num_labels)
    mask = _ignore_mask(target, ignore_index)
    target = torch.where(mask, target, 0)
    preds = _sigmoid_if_logits(preds)
    thresholds = _adjust_threshold_arg(thresholds, preds.device)
    return preds, target, thresholds, mask


def _multilabel_precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Optional[Tensor],
    mask: Optional[Tensor] = None,
) -> Union[Tensor, Tuple[Tensor, Tensor, Tensor]]:
    """Binned: the int32 ``(T, L, 2, 2)`` state, one kernel launch over all L labels."""
    if thresholds is None:
        return preds, target, (mask if mask is not None else torch.ones_like(target, dtype=torch.bool))
    len_t = thresholds.shape[0]
    preds = preds.to(torch.float32)
    w = mask.to(torch.float32) if mask is not None else torch.ones_like(preds)
    t = target.to(torch.float32) * w  # (M, L)
    pos = torch.sum(t, dim=0)
    total = torch.sum(w, dim=0)
    tp, fp = binned_curve_counts(preds, t, w, thresholds)
    return _confmat_from_counts(tp, fp, pos[None, :], (total - pos)[None, :]).reshape(len_t, num_labels, 2, 2)


def _multilabel_precision_recall_curve_compute(
    state,
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
):
    if isinstance(state, Tensor) and thresholds is not None:
        return _multiclass_precision_recall_curve_compute(state, num_labels, thresholds)
    preds, target, mask = state
    precision_list, recall_list, thresh_list = [], [], []
    for i in range(num_labels):
        p, t, m = preds[:, i], target[:, i], mask[:, i]
        if _value_check_possible(m):
            p, t = p[m], t[m]
        res = _binary_precision_recall_curve_compute((p, t), None, pos_label=1)
        precision_list.append(res[0])
        recall_list.append(res[1])
        thresh_list.append(res[2])
    return precision_list, recall_list, thresh_list


def multilabel_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds, mask = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, mask)
    return _multilabel_precision_recall_curve_compute(state, num_labels, thresholds, ignore_index)


def precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Task-dispatch façade over binary/multiclass/multilabel precision-recall curves."""
    task = str(task).lower()
    if task == "binary":
        return binary_precision_recall_curve(preds, target, thresholds, ignore_index, validate_args)
    if task == "multiclass":
        assert isinstance(num_classes, int)
        return multiclass_precision_recall_curve(preds, target, num_classes, thresholds, ignore_index, validate_args)
    if task == "multilabel":
        assert isinstance(num_labels, int)
        return multilabel_precision_recall_curve(preds, target, num_labels, thresholds, ignore_index, validate_args)
    raise ValueError(f"Expected argument `task` to either be 'binary', 'multiclass' or 'multilabel' but got {task}")
