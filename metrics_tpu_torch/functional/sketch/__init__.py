"""One-shot functional twins of the sketch metrics (port of
``metrics_tpu/functional/sketch``).

Each function runs the same kernels the module metrics accumulate with, over
one batch: a module metric fed the same stream answers bit-identically. The
state is built on the device of ``value`` when it is a tensor, else on
``device`` (default: the GPU).
"""

from __future__ import annotations

import math
from typing import Any, Sequence, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.sketch import kernels
from metrics_tpu_torch.utils.device import DeviceLike, resolve_device

__all__ = ["approx_count_distinct", "approx_quantiles", "approx_heavy_hitters"]


def _device_of(value: Any, device: DeviceLike) -> torch.device:
    if device is None and isinstance(value, Tensor):
        return value.device
    return resolve_device(device)


def approx_quantiles(
    value: Any,
    quantiles: Sequence[float] = (0.5, 0.9, 0.99),
    *,
    alpha: float = 0.01,
    n_buckets: int = 2048,
    min_trackable: float = 1e-8,
    device: DeviceLike = None,
) -> Tensor:
    """DDSketch quantile estimates of one batch (relative error <= ``alpha``)."""
    dev = _device_of(value, device)
    gamma, log_gamma, offset = kernels.ddsketch_params(alpha, min_trackable)
    pos = torch.zeros(int(n_buckets), dtype=torch.int32, device=dev)
    neg = torch.zeros(int(n_buckets), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    vmin = torch.full((), math.inf, dtype=torch.float32, device=dev)
    vmax = torch.full((), -math.inf, dtype=torch.float32, device=dev)
    pos, neg, zero, vmin, vmax = kernels.ddsketch_update(
        pos, neg, zero, vmin, vmax, value, log_gamma=log_gamma, offset=offset
    )
    return kernels.ddsketch_quantiles(pos, neg, zero, vmin, vmax, tuple(quantiles), gamma=gamma, offset=offset)


def approx_count_distinct(value: Any, *, p: int = 12, device: DeviceLike = None) -> Tensor:
    """HyperLogLog distinct-count estimate of one batch (std err ~ 1.04/sqrt(2^p))."""
    if not 4 <= int(p) <= 16:
        raise ValueError(f"`p` must be in [4, 16], got {p}")
    dev = _device_of(value, device)
    registers = kernels.hll_update(torch.zeros(1 << int(p), dtype=torch.int32, device=dev), value, p=int(p))
    return kernels.hll_estimate(registers)


def approx_heavy_hitters(
    value: Any, *, k: int = 32, depth: int = 4, width: int = 2048, device: DeviceLike = None
) -> Tuple[Tensor, Tensor]:
    """Top-``k`` heavy hitters of one batch of non-negative int ids.

    Returns ``(keys, counts)`` sorted by count-min estimate descending; unused
    candidate slots are ``-1``/``0``.
    """
    dev = _device_of(value, device)
    counts = torch.zeros((int(depth), int(width)), dtype=torch.int32, device=dev)
    ledger = torch.stack(
        [torch.full((int(k),), -1, dtype=torch.int32, device=dev), torch.zeros(int(k), dtype=torch.int32, device=dev)],
        dim=1,
    )
    counts, ledger = kernels.cms_update(counts, ledger, value)
    return kernels.hh_rank(counts, ledger)
