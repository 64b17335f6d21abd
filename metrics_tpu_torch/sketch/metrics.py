"""Mergeable sketch metrics (port of ``metrics_tpu/sketch/metrics.py``).

Each sketch registers only fixed-shape tensor states with a mergeable
``dist_reduce_fx`` (``sum``/``min``/``max``, plus the callable
:func:`~metrics_tpu_torch.sketch.kernels.topk_merge` for the heavy-hitter
ledger), so ``merge_states`` folds two streams exactly and the int32 states
replay bit-identically in any chunking.

Accuracy contracts (held against exact oracles in the tests):
:class:`QuantileSketch` relative error <= alpha within the trackable range;
:class:`CardinalitySketch` standard error ~ ``1.04/sqrt(2^p)``;
:class:`HeavyHittersSketch` never underestimates a count.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.metric import Metric, zero_state
from metrics_tpu_torch.sketch import kernels
from metrics_tpu_torch.utils.prints import rank_zero_warn

__all__ = ["CardinalitySketch", "HeavyHittersSketch", "QuantileSketch"]


class QuantileSketch(Metric):
    """DDSketch-style streaming quantiles with relative-error guarantee ``alpha``.

    State: two ``n_buckets`` int32 log-bucket stores (positive/negative
    magnitudes), an exact int32 zero count, and exact float32 running min/max.
    Answers are within ``alpha`` relative error for magnitudes in
    ``[min_trackable, min_trackable·gamma^(n_buckets-1)]``.

    Args:
        quantiles: which quantiles ``compute()`` returns, each in ``[0, 1]``.
        alpha: relative-error target, e.g. ``0.01`` = 1%.
        n_buckets: buckets per sign store.
        min_trackable: smallest magnitude tracked at full guarantee.
        device: where the states live (default: the GPU).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.sketch import QuantileSketch
        >>> m = QuantileSketch(quantiles=(0.5,), alpha=0.01, device="cpu")
        >>> m.update(torch.arange(1.0, 101.0))
        >>> bool(abs(m.compute() - 50.0) <= 1.0)
        True
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        quantiles: Sequence[float] = (0.5, 0.9, 0.99),
        alpha: float = 0.01,
        n_buckets: int = 2048,
        min_trackable: float = 1e-8,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        qs = tuple(float(q) for q in quantiles)
        if not qs or any(not 0.0 <= q <= 1.0 for q in qs):
            raise ValueError(f"`quantiles` must be non-empty values in [0, 1], got {quantiles!r}")
        if int(n_buckets) < 2:
            raise ValueError(f"`n_buckets` must be >= 2, got {n_buckets}")
        self.quantiles = qs
        self.alpha = float(alpha)
        self.n_buckets = int(n_buckets)
        self.min_trackable = float(min_trackable)
        self._gamma, self._log_gamma, self._offset = kernels.ddsketch_params(self.alpha, self.min_trackable)
        # the trackable ceiling is min_trackable·gamma^(B-1): few buckets at a
        # tight alpha can put it BELOW ordinary data and clip every value into
        # the top bucket, so that misconfiguration is made loud
        max_trackable = self.min_trackable * self._gamma ** (self.n_buckets - 1)
        if max_trackable < 1.0:
            rank_zero_warn(
                f"QuantileSketch(alpha={self.alpha}, n_buckets={self.n_buckets}, "
                f"min_trackable={self.min_trackable}) only tracks magnitudes up to "
                f"{max_trackable:.3g} at the α guarantee — larger values clip into the "
                "top bucket. Raise `n_buckets`, `alpha`, or `min_trackable` so the "
                "range covers your data.",
                UserWarning,
            )
        dev = self.device
        self.add_state("pos_buckets", zero_state(self.n_buckets, torch.int32, dev), dist_reduce_fx="sum")
        self.add_state("neg_buckets", zero_state(self.n_buckets, torch.int32, dev), dist_reduce_fx="sum")
        self.add_state("zero_count", zero_state((), torch.int32, dev), dist_reduce_fx="sum")
        self.add_state("min_value", torch.full((), math.inf, dtype=torch.float32, device=dev), dist_reduce_fx="min")
        self.add_state("max_value", torch.full((), -math.inf, dtype=torch.float32, device=dev), dist_reduce_fx="max")

    def update(self, value: Union[float, Tensor]) -> None:
        (
            self.pos_buckets,
            self.neg_buckets,
            self.zero_count,
            self.min_value,
            self.max_value,
        ) = kernels.ddsketch_update(
            self.pos_buckets,
            self.neg_buckets,
            self.zero_count,
            self.min_value,
            self.max_value,
            value,
            log_gamma=self._log_gamma,
            offset=self._offset,
        )

    def compute(self) -> Tensor:
        """One estimate per configured quantile (NaN before any update)."""
        return kernels.ddsketch_quantiles(
            self.pos_buckets,
            self.neg_buckets,
            self.zero_count,
            self.min_value,
            self.max_value,
            self.quantiles,
            gamma=self._gamma,
            offset=self._offset,
        )

    def quantile_from(self, state: Any, q: Union[float, Sequence[float]]) -> Tensor:
        """Estimate arbitrary quantile(s) ``q`` from a state dict: a scalar
        ``q`` gives a scalar, a sequence one estimate per entry."""
        scalar = isinstance(q, (int, float))
        qs = (float(q),) if scalar else tuple(float(v) for v in q)
        if not qs or any(not 0.0 <= v <= 1.0 for v in qs):
            raise ValueError(f"`q` must be value(s) in [0, 1], got {q!r}")
        out = kernels.ddsketch_quantiles(
            state["pos_buckets"],
            state["neg_buckets"],
            state["zero_count"],
            state["min_value"],
            state["max_value"],
            qs,
            gamma=self._gamma,
            offset=self._offset,
        )
        return out[0] if scalar else out


class CardinalitySketch(Metric):
    """HyperLogLog distinct-count estimator over ``m = 2^p`` int32 registers.

    Standard error ~ ``1.04/sqrt(m)``. Identity is the 32-bit pattern of the
    value. Merge is elementwise register max: exact, order-independent,
    idempotent.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.sketch import CardinalitySketch
        >>> m = CardinalitySketch(p=10, device="cpu")
        >>> m.update(torch.arange(300, dtype=torch.int32))
        >>> bool(abs(m.compute() - 300) <= 30)
        True
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(self, p: int = 12, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not 4 <= int(p) <= 16:
            raise ValueError(f"`p` must be in [4, 16], got {p}")
        self.p = int(p)
        self.add_state("registers", zero_state(1 << self.p, torch.int32, self.device), dist_reduce_fx="max")

    def update(self, value: Union[float, Tensor]) -> None:
        self.registers = kernels.hll_update(self.registers, value, p=self.p)

    def compute(self) -> Tensor:
        """Estimated number of distinct values seen (float32 scalar)."""
        return kernels.hll_estimate(self.registers)


class HeavyHittersSketch(Metric):
    """Count-min heavy hitters with a top-``k`` candidate ledger.

    State: a ``depth x width`` int32 count-min table (merge: sum, exact) and a
    ``(k, 2)`` int32 ``[key, count]`` ledger (merge: the callable
    :func:`~metrics_tpu_torch.sketch.kernels.topk_merge`). Items must be
    non-negative int32 ids; ``-1`` marks an empty ledger slot. ``compute()``
    re-estimates every candidate against the count-min table and returns them
    sorted by estimated count descending.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.sketch import HeavyHittersSketch
        >>> m = HeavyHittersSketch(k=4, device="cpu")
        >>> m.update(torch.tensor([7, 7, 7, 3, 3, 9]))
        >>> keys, counts = m.compute()
        >>> int(keys[0]), int(counts[0])
        (7, 3)
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(self, k: int = 32, depth: int = 4, width: int = 2048, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if int(k) < 1:
            raise ValueError(f"`k` must be >= 1, got {k}")
        if int(depth) < 1 or int(width) < 2:
            raise ValueError(f"`depth` must be >= 1 and `width` >= 2, got {depth}x{width}")
        self.k = int(k)
        self.depth = int(depth)
        self.width = int(width)
        dev = self.device
        self.add_state("counts", zero_state((self.depth, self.width), torch.int32, dev), dist_reduce_fx="sum")
        empty = torch.stack(
            [torch.full((self.k,), -1, dtype=torch.int32, device=dev), torch.zeros(self.k, dtype=torch.int32, device=dev)],
            dim=1,
        )
        self.add_state("ledger", empty, dist_reduce_fx=kernels.topk_merge)

    def update(self, value: Union[int, Tensor]) -> None:
        self.counts, self.ledger = kernels.cms_update(self.counts, self.ledger, value)

    def compute(self) -> Tuple[Tensor, Tensor]:
        """``(keys, counts)``: the candidate ids (``-1`` pads unused slots) and
        their count-min estimates, sorted by count descending (key ties broken
        deterministically)."""
        return kernels.hh_rank(self.counts, self.ledger)

    def topk_from(self, state: Any, k: Optional[int] = None) -> Tuple[Tensor, Tensor]:
        """Ranked ``(keys, counts)`` from a state dict, truncated to ``k``
        (default: the ledger's full ``k``; more is an error)."""
        if k is None:
            k = self.k
        if not 1 <= int(k) <= self.k:
            raise ValueError(f"`k` must be in [1, {self.k}] (the ledger size), got {k}")
        keys, counts = kernels.hh_rank(state["counts"], state["ledger"])
        return keys[: int(k)], counts[: int(k)]
