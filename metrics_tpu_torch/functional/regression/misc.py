"""The other regression functionals: cosine similarity, KL divergence, Tweedie
deviance, Spearman's and Kendall's rank correlations (port of
``metrics_tpu/functional/regression/misc.py``).

Plain torch code on the inputs' own device, no kernel. The rank correlations
run on the whole concatenated sample and never move it to the host:

- Spearman's average ranks come from one stable sort and its runs of equal
  values (``_rank_data``), the JAX package's host route (``_rank_data_host``)
  on the device: ranks are halves of small integers, exact in float32, so
  they equal the CPU's bit for bit.
- Kendall's concordant, discordant and tied pairs are counted exactly in
  int64 over row tiles of the pair grid (``_kendall_counts``), so N = 2^15
  (2^29 pairs) fits in a few hundred MB of scratch on the card. The JAX
  package sums the full (N, N) grid in int32, which wraps past N = 65,536
  (ROADMAP C.14); below that the counts are equal.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.compute import _safe_xlogy

# elements of one tile of Kendall's pair grid (rows x N), four tiles live at once
_KENDALL_TILE_ELEMENTS = 1 << 24


def _x32_float(x: Tensor) -> Tensor:
    """Float64 as float32 and integers as float32 (the JAX package's true
    division promotes them so); float32 and float16 stay as they are."""
    x = torch.as_tensor(x)
    if x.dtype == torch.float64 or not x.is_floating_point():
        return x.to(torch.float32)
    return x


# --------------------------------------------------------------------------- cosine similarity


def _cosine_similarity_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    if preds.ndim != 2:
        raise ValueError(f"Expected input to cosine similarity to be 2D tensors of shape `[N,D]`, got {preds.ndim}D")
    return preds.to(torch.float32), target.to(torch.float32)


_REDUCTIONS = {"sum": torch.sum, "mean": torch.mean, "none": lambda x: x, None: lambda x: x}


def _cosine_similarity_compute(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    dot_product = torch.sum(preds * target, dim=-1)
    preds_norm = torch.linalg.vector_norm(preds, dim=-1)
    target_norm = torch.linalg.vector_norm(target, dim=-1)
    similarity = dot_product / (preds_norm * target_norm)
    return _REDUCTIONS[reduction](similarity)


def cosine_similarity(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    """Cosine similarity of each row pair, reduced.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import cosine_similarity
        >>> preds = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
        >>> target = torch.tensor([[1.0, 1.0], [3.0, 5.0]])
        >>> cosine_similarity(preds, target, reduction="mean")
        tensor(0.9717)
    """
    preds, target = _cosine_similarity_update(preds, target)
    return _cosine_similarity_compute(preds, target, reduction)


# --------------------------------------------------------------------------- kl divergence


def _kld_update(p: Tensor, q: Tensor, log_prob: bool) -> Tuple[Tensor, int]:
    """One KL measure a row and the number of rows. Without ``log_prob`` the
    rows are normalised, and a zero ``q`` under mass of ``p`` gives inf."""
    _check_same_shape(p, q)
    if p.ndim != 2 or q.ndim != 2:
        raise ValueError(f"Expected both p and q distribution to be 2D but got {p.ndim} and {q.ndim} respectively")
    p, q = _x32_float(p), _x32_float(q)
    total = p.shape[0]
    if log_prob:
        measures = torch.sum(torch.exp(p) * (p - q), dim=-1)
    else:
        p = p / torch.sum(p, dim=-1, keepdim=True)
        q = q / torch.sum(q, dim=-1, keepdim=True)
        measures = torch.sum(_safe_xlogy(p, p / q), dim=-1)
    return measures, total


def _kld_compute(measures: Tensor, total: Union[int, Tensor], reduction: Optional[str] = "mean") -> Tensor:
    if reduction == "sum":
        return torch.sum(measures)
    if reduction == "mean":
        return torch.sum(measures) / total
    if reduction is None or reduction == "none":
        return measures
    return measures / total


def kl_divergence(p: Tensor, q: Tensor, log_prob: bool = False, reduction: Optional[str] = "mean") -> Tensor:
    """KL divergence of each row of ``q`` from the same row of ``p``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import kl_divergence
        >>> p = torch.tensor([[0.4, 0.6], [0.5, 0.5]])
        >>> q = torch.tensor([[0.3, 0.7], [0.5, 0.5]])
        >>> kl_divergence(p, q)
        tensor(0.0113)
    """
    measures, total = _kld_update(p, q, log_prob)
    return _kld_compute(measures, total, reduction)


# --------------------------------------------------------------------------- tweedie deviance


def _tweedie_deviance_score_update(preds: Tensor, target: Tensor, power: float = 0.0) -> Tuple[Tensor, float]:
    """The sum of the deviances and the number of values (a Python float: no
    host-to-device copy, so the update can be captured)."""
    _check_same_shape(preds, target)
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)

    if power == 0:
        deviance_score = torch.pow(target - preds, 2)
    elif power == 1:
        deviance_score = 2 * (_safe_xlogy(target, target / preds) + preds - target)
    elif power == 2:
        deviance_score = 2 * (torch.log(preds / target) + (target / preds) - 1)
    else:  # power < 0, 1 < power < 2 or power > 2: the general formula
        target_term = torch.clamp(target, min=0.0) if power < 0 else target
        deviance_score = 2 * (
            torch.pow(target_term, 2 - power) / ((1 - power) * (2 - power))
            - target * torch.pow(preds, 1 - power) / (1 - power)
            + torch.pow(preds, 2 - power) / (2 - power)
        )
    return torch.sum(deviance_score), float(target.numel())


def _tweedie_deviance_score_compute(sum_deviance_score: Tensor, num_observations: Union[Tensor, float]) -> Tensor:
    return sum_deviance_score / num_observations


def tweedie_deviance_score(preds: Tensor, target: Tensor, power: float = 0.0) -> Tensor:
    """Mean Tweedie deviance.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import tweedie_deviance_score
        >>> preds = torch.tensor([0.5, 1.2, 2.0, 4.0])
        >>> target = torch.tensor([0.6, 1.0, 2.5, 3.5])
        >>> tweedie_deviance_score(preds, target)
        tensor(0.1375)
    """
    if 0 < power < 1:
        raise ValueError(f"Deviance Score is not defined for power={power}.")
    s, n = _tweedie_deviance_score_update(preds, target, power)
    return _tweedie_deviance_score_compute(s, n)


# --------------------------------------------------------------------------- spearman


def _rank_data(x: Tensor) -> Tensor:
    """Average-tie ranks (1-based, float32) of a 1-D tensor, on its device.

    One stable sort; each run of equal sorted values (``!=`` between
    neighbours, so every NaN is a run of its own) gets the mean of its 1-based
    positions, ``(first + last) / 2 + 1``, and the runs' ranks are scattered
    back through the sort's permutation. A run's first position is the
    exclusive prefix sum of the run lengths (scans over the whole tensor, not
    ``torch.cummax``, whose CUDA scan of one long row runs in one block)."""
    n = x.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.float32, device=x.device)
    sorted_x, order = torch.sort(x, stable=True)
    new = torch.ones(n, dtype=torch.bool, device=x.device)
    torch.ne(sorted_x[1:], sorted_x[:-1], out=new[1:])
    run = torch.cumsum(new, dim=0) - 1
    length = torch.zeros(n, dtype=torch.int64, device=x.device).index_add_(0, run, torch.ones_like(run))
    first = (torch.cumsum(length, dim=0) - length)[run]
    ranks = (2 * first + length[run] - 1).to(torch.float32) / 2.0 + 1.0
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    out[order] = ranks
    return out


def _spearman_corrcoef_compute(preds: Tensor, target: Tensor, eps: float = 1.17e-06) -> Tensor:
    """Ranks, then Pearson's coefficient of the ranks (population moments)."""
    if preds.ndim == 1:
        preds = _rank_data(preds)
        target = _rank_data(target)
    else:
        preds = torch.stack([_rank_data(preds[:, i]) for i in range(preds.shape[1])], dim=-1)
        target = torch.stack([_rank_data(target[:, i]) for i in range(target.shape[1])], dim=-1)

    preds_diff = preds - torch.mean(preds, dim=0)
    target_diff = target - torch.mean(target, dim=0)

    cov = torch.mean(preds_diff * target_diff, dim=0)
    preds_std = torch.sqrt(torch.mean(preds_diff * preds_diff, dim=0))
    target_std = torch.sqrt(torch.mean(target_diff * target_diff, dim=0))

    corrcoef = cov / (preds_std * target_std + eps)
    return torch.clamp(corrcoef, -1.0, 1.0)


def _floating_or_raise(preds: Tensor, target: Tensor) -> None:
    if not preds.is_floating_point() or not target.is_floating_point():
        raise TypeError("Expected `preds` and `target` both to be floating point tensors")


def spearman_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Spearman's rank correlation.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import spearman_corrcoef
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> spearman_corrcoef(preds, target)
        tensor(1.0000)
    """
    _check_same_shape(preds, target)
    _floating_or_raise(preds, target)
    return _spearman_corrcoef_compute(preds.to(torch.float32), target.to(torch.float32))


# --------------------------------------------------------------------------- kendall


def _kendall_counts(preds: Tensor, target: Tensor) -> Tensor:
    """int64 ``(concordant, discordant, ties in x, ties in y)`` over the pairs
    i < j, as the JAX package's grid counts them: the signs of
    ``x_i - x_j`` and ``y_i - y_j``, their product above or below 0, a
    difference equal to 0 a tie (a NaN difference counts nowhere).

    The grid is walked in tiles of rows, so no more than
    ``_KENDALL_TILE_ELEMENTS`` pairs live at once; a tile's columns right of
    its last row need no mask, and only its own triangle does."""
    n = preds.shape[0]
    counts = torch.zeros(4, dtype=torch.int64, device=preds.device)
    rows = max(1, _KENDALL_TILE_ELEMENTS // max(n, 1))
    index = torch.arange(n, device=preds.device)
    for i0 in range(0, n, rows):
        i1 = min(n, i0 + rows)
        for j0, j1 in ((i0 + 1, i1), (i1, n)):
            if j1 <= j0:
                continue
            px = torch.sign(preds[i0:i1, None] - preds[None, j0:j1])
            py = torch.sign(target[i0:i1, None] - target[None, j0:j1])
            s = px * py
            kinds = [s > 0, s < 0, px == 0, py == 0]
            if j0 < i1:  # the tile's own triangle: keep j > i
                upper = index[None, j0:j1] > index[i0:i1, None]
                kinds = [k & upper for k in kinds]
            counts += torch.stack([k.sum(dtype=torch.int64) for k in kinds])
    return counts


def _distinct_finite(x: Tensor) -> Tensor:
    """The number of distinct finite values (``jnp.unique(size=n)`` padded with
    inf, its finite entries counted); -0.0 and 0.0 are one value."""
    return torch.isfinite(torch.unique(x)).sum()


def _kendall_tau_compute(preds: Tensor, target: Tensor, variant: str = "b") -> Tensor:
    """Kendall's tau from the exact pair counts. The JAX package divides int32
    counts, and its true division converts each integer operand to float32:
    so do the differences here, taken in int64 before the conversion."""
    concordant, discordant, tx, ty = _kendall_counts(preds, target).unbind(0)
    n = preds.shape[0]
    if variant == "a":
        # ties drop out of the denominator: (C - D) / (C + D)
        return (concordant - discordant).to(torch.float32) / (concordant + discordant).to(torch.float32)
    if variant == "b":
        n0 = n * (n - 1) / 2.0
        tx, ty = tx.to(torch.float32), ty.to(torch.float32)
        return (concordant - discordant).to(torch.float32) / torch.sqrt((n0 - tx) * (n0 - ty))
    m = torch.minimum(_distinct_finite(preds), _distinct_finite(target)).to(torch.float32)
    return (2 * (concordant - discordant)).to(torch.float32) / (n**2 * (m - 1) / m)


_ALTERNATIVES = ("two-sided", "less", "greater")


def _kendall_p_value(tau: Tensor, n: int, alternative: str) -> Tensor:
    """Normal-approximation p-value: z = 3·tau·sqrt(n(n−1)) / sqrt(2(2n+5)),
    the square roots taken in float32 as ``jnp.sqrt`` takes them."""

    def sqrt32(v: float) -> Tensor:
        return torch.sqrt(torch.tensor(v, dtype=torch.float32, device=tau.device))

    z = 3 * tau * sqrt32(n * (n - 1.0)) / sqrt32(2.0 * (2 * n + 5.0))
    if alternative == "two-sided":
        return 2 * torch.special.ndtr(-torch.abs(z))
    if alternative == "greater":
        return torch.special.ndtr(-z)
    if alternative == "less":
        return torch.special.ndtr(z)
    raise ValueError(
        f"Argument `alternative` is expected to be one of `{list(_ALTERNATIVES)}`, but got {alternative!r}"
    )


def _kendall_arg_validation(variant: str, t_test: bool) -> None:
    if variant not in ("a", "b", "c"):
        raise ValueError(f"Argument `variant` is expected to be one of `['a', 'b', 'c']`, but got {variant!r}")
    if not isinstance(t_test, bool):
        raise ValueError(f"Argument `t_test` is expected to be of a type `bool`, but got {t_test!r}")


def kendall_rank_corrcoef(
    preds: Tensor,
    target: Tensor,
    variant: str = "b",
    t_test: bool = False,
    alternative: Optional[str] = "two-sided",
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Kendall's rank correlation; with ``t_test=True``, ``(tau, p_value)``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import kendall_rank_corrcoef
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> kendall_rank_corrcoef(preds, target)
        tensor(1.)
    """
    _check_same_shape(preds, target)
    _kendall_arg_validation(variant, t_test)
    if t_test and alternative not in _ALTERNATIVES:
        raise ValueError(
            f"Argument `alternative` is expected to be one of `{list(_ALTERNATIVES)}`, but got {alternative!r}"
        )
    if preds.ndim == 1:
        tau = _kendall_tau_compute(preds.to(torch.float32), target.to(torch.float32), variant)
    else:
        tau = torch.stack([
            _kendall_tau_compute(preds[:, i].to(torch.float32), target[:, i].to(torch.float32), variant)
            for i in range(preds.shape[1])
        ])
    if t_test:
        return tau, _kendall_p_value(tau, preds.shape[0], alternative)
    return tau
