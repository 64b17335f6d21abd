"""Nominal association statistics: Cramér's V, Pearson's contingency
coefficient, Tschuprow's T and Theil's U, and their ``*_matrix`` forms over the
columns of a matrix (port of ``metrics_tpu/functional/nominal/stats.py``).

Each functional formats its labels as the JAX package does (float inputs of
more than one dimension through an argmax, then a cast through float32, so
labels above 2^24 round, then NaN handling, then int32), takes the number of
categories as the largest label + 1 (a host read), counts the contingency
table by the pair count (one ``csrc/pair_count.cu`` launch on the card) and
reduces it in float32. The symmetric ``*_matrix`` forms count one table a
column pair (D(D-1)/2); ``theils_u_matrix`` one an ordered pair (D(D-1)).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.nominal.utils import (
    _compute_bias_corrected_dims,
    _drop_empty_rows_and_cols,
    _handle_nan_in_data,
    _joint_confusion_matrix,
    _nominal_input_validation,
    _unable_to_compute_warning,
)
from metrics_tpu_torch.utils.checks import _as_x32, _value_check_possible

_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1


def _chi2_phi2(confmat: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Chi-squared statistic, phi2 and total of a contingency table, float32.

    The expected counts are ``row * col / n``: the JAX package's ``row @ col``
    is a product of a column by a row, one term a cell, so the same products."""
    cm = confmat.to(torch.float32)
    n = torch.sum(cm)
    row = torch.sum(cm, dim=1, keepdim=True)
    col = torch.sum(cm, dim=0, keepdim=True)
    expected = row * col / n
    positive = expected > 0
    chi2 = torch.sum(torch.where(positive, (cm - expected) ** 2 / torch.where(positive, expected, 1.0), 0.0))
    return chi2, chi2 / n, n


def _num_classes_of(*tensors: Tensor) -> int:
    """Largest label + 1 (0 for empty inputs counts as label 0): one host read."""
    return max(int(t.max()) if t.numel() else 0 for t in tensors) + 1


def _saturating_int32(x: Tensor) -> Tensor:
    """float32 to int32 as XLA converts: toward zero, saturating at the int32
    range, NaN to 0 (a plain cast wraps or is undefined out of range)."""
    as_int = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0).clamp(-(2.0**31), 2.0**31 - 128).to(torch.int32)
    as_int = torch.where(x >= 2.0**31, _INT32_MAX, as_int)
    return torch.where(x <= -(2.0**31), _INT32_MIN, as_int)


def _format_nominal(preds: Tensor, target: Tensor, nan_strategy: str, nan_replace_value: Optional[float]
                    ) -> Tuple[Tensor, Tensor]:
    preds = _as_x32(preds)
    target = _as_x32(target)
    if preds.is_floating_point() and preds.ndim > 1:
        preds = torch.argmax(preds, dim=1)
    if target.is_floating_point() and target.ndim > 1:
        target = torch.argmax(target, dim=1)
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    preds, target = _handle_nan_in_data(preds, target, nan_strategy, nan_replace_value)
    return _saturating_int32(preds), _saturating_int32(target)


def _table_of(preds: Tensor, target: Tensor, nan_strategy: str, nan_replace_value: Optional[float]) -> Tensor:
    _nominal_input_validation(nan_strategy, nan_replace_value)
    preds, target = _format_nominal(preds, target, nan_strategy, nan_replace_value)
    nc = _num_classes_of(preds, target)
    return _joint_confusion_matrix(preds, target, nc, nc)


def _bias_corrected_phi2(confmat: Tensor, phi2: Tensor, n: Tensor, metric: str) -> Optional[Tuple[Tensor, Tensor, Tensor]]:
    """``(phi2, r_c, k_c)`` after the bias correction, or None (with the JAX
    package's warning) where a corrected dimension is 1."""
    r, k = confmat.shape
    phi2 = torch.clamp(phi2 - (k - 1) * (r - 1) / (n - 1), min=0.0)
    r_c, k_c = _compute_bias_corrected_dims(confmat)
    if _value_check_possible(r_c) and (float(r_c) == 1.0 or float(k_c) == 1.0):
        _unable_to_compute_warning(metric)
        return None
    return phi2, r_c, k_c


def _nan_like(confmat: Tensor) -> Tensor:
    return torch.full((), float("nan"), dtype=torch.float32, device=confmat.device)


def _cramers_v_compute(confmat: Tensor, bias_correction: bool) -> Tensor:
    confmat = _drop_empty_rows_and_cols(confmat)
    _, phi2, n = _chi2_phi2(confmat)
    r, k = confmat.shape
    if bias_correction:
        corrected = _bias_corrected_phi2(confmat, phi2, n, "Cramer's V")
        if corrected is None:
            return _nan_like(confmat)
        phi2, r_c, k_c = corrected
        v = torch.sqrt(phi2 / torch.minimum(r_c - 1.0, k_c - 1.0))
    else:
        v = torch.sqrt(phi2 / min(r - 1, k - 1))
    return torch.clamp(v, 0.0, 1.0)


def cramers_v(
    preds: Tensor,
    target: Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Cramér's V of two label vectors.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import cramers_v
        >>> preds = torch.tensor([0, 1, 2, 1, 0, 2, 1, 2])
        >>> target = torch.tensor([0, 1, 2, 2, 0, 1, 1, 2])
        >>> cramers_v(preds, target)
        tensor(0.6146)
    """
    return _cramers_v_compute(_table_of(preds, target, nan_strategy, nan_replace_value), bias_correction)


def _pearsons_contingency_coefficient_compute(confmat: Tensor) -> Tensor:
    confmat = _drop_empty_rows_and_cols(confmat)
    _, phi2, _ = _chi2_phi2(confmat)
    return torch.clamp(torch.sqrt(phi2 / (1 + phi2)), 0.0, 1.0)


def pearsons_contingency_coefficient(
    preds: Tensor,
    target: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Pearson's contingency coefficient of two label vectors.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pearsons_contingency_coefficient
        >>> preds = torch.tensor([0, 1, 2, 1, 0, 2, 1, 2])
        >>> target = torch.tensor([0, 1, 2, 2, 0, 1, 1, 2])
        >>> pearsons_contingency_coefficient(preds, target)
        tensor(0.7255)
    """
    return _pearsons_contingency_coefficient_compute(_table_of(preds, target, nan_strategy, nan_replace_value))


def _tschuprows_t_compute(confmat: Tensor, bias_correction: bool) -> Tensor:
    confmat = _drop_empty_rows_and_cols(confmat)
    _, phi2, n = _chi2_phi2(confmat)
    r, k = confmat.shape
    if bias_correction:
        corrected = _bias_corrected_phi2(confmat, phi2, n, "Tschuprow's T")
        if corrected is None:
            return _nan_like(confmat)
        phi2, r_c, k_c = corrected
        t = torch.sqrt(phi2 / torch.sqrt((r_c - 1.0) * (k_c - 1.0)))
    else:
        t = torch.sqrt(phi2 / torch.sqrt(torch.tensor(float((r - 1) * (k - 1)), device=phi2.device)))
    return torch.clamp(t, 0.0, 1.0)


def tschuprows_t(
    preds: Tensor,
    target: Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Tschuprow's T of two label vectors.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import tschuprows_t
        >>> preds = torch.tensor([0, 1, 2, 1, 0, 2, 1, 2])
        >>> target = torch.tensor([0, 1, 2, 2, 0, 1, 1, 2])
        >>> tschuprows_t(preds, target)
        tensor(0.6146)
    """
    return _tschuprows_t_compute(_table_of(preds, target, nan_strategy, nan_replace_value), bias_correction)


def _theils_u_compute(confmat: Tensor) -> Tensor:
    """U(X|Y), the uncertainty coefficient; 0 where X has zero entropy."""
    confmat = _drop_empty_rows_and_cols(confmat)
    cm = confmat.to(torch.float32)
    total = torch.sum(cm)

    p_x = torch.sum(cm, dim=1) / total
    h_x = -torch.sum(torch.where(p_x > 0, p_x * torch.log(torch.where(p_x > 0, p_x, 1.0)), 0.0))

    p_y = torch.sum(cm, dim=0, keepdim=True) / total
    p_xy = cm / total
    h_xy = -torch.sum(torch.where(p_xy > 0, p_xy * torch.log(torch.where(p_xy > 0, p_xy / p_y, 1.0)), 0.0))

    zero = h_x == 0.0
    return torch.where(zero, torch.zeros_like(h_x), (h_x - h_xy) / torch.where(zero, 1.0, h_x))


def theils_u(
    preds: Tensor,
    target: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Theil's U of two label vectors.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import theils_u
        >>> preds = torch.tensor([0, 1, 2, 1, 0, 2, 1, 2])
        >>> target = torch.tensor([0, 1, 2, 2, 0, 1, 1, 2])
        >>> theils_u(preds, target)
        tensor(0.5589)
    """
    return _theils_u_compute(_table_of(preds, target, nan_strategy, nan_replace_value))


def _matrix(fn: Callable[[Tensor, Tensor], Tensor], matrix: Tensor, symmetric: bool) -> Tensor:
    """Column-association matrix, 1 on the diagonal: ``fn`` of every column pair
    i < j mirrored (symmetric), or of every ordered pair i != j."""
    num_var = matrix.shape[1]
    out = torch.ones((num_var, num_var), dtype=torch.float32, device=matrix.device)
    for i in range(num_var):
        for j in range(i + 1 if symmetric else 0, num_var):
            if i == j:
                continue
            out[i, j] = fn(matrix[:, i], matrix[:, j])
            if symmetric:
                out[j, i] = out[i, j]
    return out


def cramers_v_matrix(matrix: Tensor, bias_correction: bool = True, nan_strategy: str = "replace",
                     nan_replace_value: Optional[float] = 0.0) -> Tensor:
    """Cramér's V of every pair of columns.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import cramers_v_matrix
        >>> matrix = torch.tensor([[0, 1], [1, 0], [2, 1], [1, 2], [0, 0], [2, 2]])
        >>> cramers_v_matrix(matrix)
        tensor([[1., 0.],
                [0., 1.]])
    """
    return _matrix(lambda a, b: cramers_v(a, b, bias_correction, nan_strategy, nan_replace_value), matrix, True)


def pearsons_contingency_coefficient_matrix(matrix: Tensor, nan_strategy: str = "replace",
                                            nan_replace_value: Optional[float] = 0.0) -> Tensor:
    """Pearson's contingency coefficient of every pair of columns.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pearsons_contingency_coefficient_matrix
        >>> matrix = torch.tensor([[0, 1], [1, 0], [2, 1], [1, 2], [0, 0], [2, 2]])
        >>> pearsons_contingency_coefficient_matrix(matrix)
        tensor([[1.0000, 0.5774],
                [0.5774, 1.0000]])
    """
    return _matrix(lambda a, b: pearsons_contingency_coefficient(a, b, nan_strategy, nan_replace_value), matrix, True)


def tschuprows_t_matrix(matrix: Tensor, bias_correction: bool = True, nan_strategy: str = "replace",
                        nan_replace_value: Optional[float] = 0.0) -> Tensor:
    """Tschuprow's T of every pair of columns.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import tschuprows_t_matrix
        >>> matrix = torch.tensor([[0, 1], [1, 0], [2, 1], [1, 2], [0, 0], [2, 2]])
        >>> tschuprows_t_matrix(matrix)
        tensor([[1., 0.],
                [0., 1.]])
    """
    return _matrix(lambda a, b: tschuprows_t(a, b, bias_correction, nan_strategy, nan_replace_value), matrix, True)


def theils_u_matrix(matrix: Tensor, nan_strategy: str = "replace", nan_replace_value: Optional[float] = 0.0) -> Tensor:
    """Theil's U of every ordered pair of columns (it is not symmetric).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import theils_u_matrix
        >>> matrix = torch.tensor([[0, 1], [1, 0], [2, 1], [1, 2], [0, 0], [2, 2]])
        >>> theils_u_matrix(matrix)
        tensor([[1.0000, 0.3691],
                [0.3691, 1.0000]])
    """
    return _matrix(lambda a, b: theils_u(a, b, nan_strategy, nan_replace_value), matrix, False)
