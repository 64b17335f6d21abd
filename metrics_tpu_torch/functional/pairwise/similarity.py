"""Pairwise similarity and distance matrices: cosine, euclidean, manhattan and
linear (port of ``metrics_tpu/functional/pairwise/similarity.py``).

One function on every device, the JAX package's eager-CPU route
(``_host_pairwise``), which its tests read:

- inputs are cast to float32 (float64, float16 and integers alike);
- cosine divides each row by its norm (a zero row gives NaN) and multiplies;
- euclidean takes the ``|x|² + |y|² − 2x·y`` expansion in float64 (the H100
  has FP64 units), casts the squared distances back to float32 and clamps
  them at 0 before the square root, so near-duplicate rows keep the
  accuracy of the float64 expansion, not the cancellation of a float32 one;
- manhattan sums ``|x_i − y_j|`` over row tiles of x, so the (N, M, D)
  difference never lives whole;
- in self mode (no ``y``) the diagonal is pinned to 0 unless
  ``zero_diagonal=False`` asks for the raw values.

The products are ``torch.matmul``: the JAX package computes them outside any
Pallas kernel. TF32 is the caller's setting (off by default in PyTorch).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

# elements of one (rows, M, D) tile of the manhattan difference
_MANHATTAN_TILE_ELEMENTS = 1 << 26


def _check_input(
    x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None
) -> Tuple[Tensor, Tensor, bool]:
    """Shapes checked, both as float32; ``zero_diagonal`` defaults to True in
    self mode (``y`` is ``x``) and to False otherwise."""
    if x.ndim != 2:
        raise ValueError(f"Expected argument `x` to be a 2D tensor of shape `[N, d]` but got {x.shape}")
    if y is not None:
        if y.ndim != 2 or y.shape[1] != x.shape[1]:
            raise ValueError(
                "Expected argument `y` to be a 2D tensor of shape `[M, d]` where"
                " `d` should be same as the last dimension of `x`"
            )
        return x.to(torch.float32), y.to(torch.float32), False if zero_diagonal is None else zero_diagonal
    x = x.to(torch.float32)
    return x, x, True if zero_diagonal is None else zero_diagonal


def _validate_reduction(reduction: Optional[str]) -> None:
    if reduction not in ("mean", "sum", "none", None):
        raise ValueError(f"Expected reduction to be one of `['mean', 'sum', None]` but got {reduction}")


def _finish(mat: Tensor, zero_diagonal: bool, reduction: Optional[str]) -> Tensor:
    if zero_diagonal:
        mat.fill_diagonal_(0.0)
    if reduction == "mean":
        return mat.mean(dim=-1)
    if reduction == "sum":
        return mat.sum(dim=-1)
    return mat


def _unit_rows(x: Tensor) -> Tensor:
    # plain division: a zero row has no direction, and its similarities are NaN
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def pairwise_cosine_similarity(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Cosine similarity matrix.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pairwise_cosine_similarity
        >>> x = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
        >>> y = torch.tensor([[0.0, 1.0], [2.0, 2.0]])
        >>> pairwise_cosine_similarity(x, y)
        tensor([[0.8944, 0.9487],
                [0.8000, 0.9899]])
    """
    same = y is None
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    _validate_reduction(reduction)
    xn = _unit_rows(x)
    yn = xn if same else _unit_rows(y)
    return _finish(xn @ yn.T, zero_diagonal, reduction)


def pairwise_euclidean_distance(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Euclidean distance matrix through the float64 expansion.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pairwise_euclidean_distance
        >>> x = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
        >>> y = torch.tensor([[0.0, 1.0], [2.0, 2.0]])
        >>> pairwise_euclidean_distance(x, y)
        tensor([[1.4142, 1.0000],
                [4.2426, 2.2361]])
    """
    same = y is None
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    _validate_reduction(reduction)
    x64 = x.to(torch.float64)
    y64 = x64 if same else y.to(torch.float64)
    x_norm = torch.sum(x64 * x64, dim=1, keepdim=True)
    y_norm = x_norm.reshape(-1) if same else torch.sum(y64 * y64, dim=1)
    sq = (x_norm + y_norm[None, :] - 2.0 * (x64 @ y64.T)).to(torch.float32)
    return _finish(torch.sqrt(torch.clamp(sq, min=0.0)), zero_diagonal, reduction)


def pairwise_manhattan_distance(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Manhattan (L1) distance matrix.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pairwise_manhattan_distance
        >>> x = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
        >>> y = torch.tensor([[0.0, 1.0], [2.0, 2.0]])
        >>> pairwise_manhattan_distance(x, y)
        tensor([[2., 1.],
                [6., 3.]])
    """
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    _validate_reduction(reduction)
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    rows = max(1, _MANHATTAN_TILE_ELEMENTS // max(m * d, 1))
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    for i0 in range(0, n, rows):
        out[i0:i0 + rows] = torch.sum(torch.abs(x[i0:i0 + rows, None, :] - y[None, :, :]), dim=-1)
    return _finish(out, zero_diagonal, reduction)


def pairwise_linear_similarity(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Linear (dot-product) similarity matrix.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pairwise_linear_similarity
        >>> x = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
        >>> y = torch.tensor([[0.0, 1.0], [2.0, 2.0]])
        >>> pairwise_linear_similarity(x, y)
        tensor([[ 2.,  6.],
                [ 4., 14.]])
    """
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    _validate_reduction(reduction)
    return _finish(x @ y.T, zero_diagonal, reduction)
