"""Pure-functional mergeable sketch kernels (port of ``metrics_tpu/sketch/kernels.py``).

Three families of fixed-shape int32 states with mergeable reductions:

- **DDSketch-style quantile sketch**: log-bucketed counters with relative
  error ``alpha``, separate positive/negative stores, an exact zero count and
  exact running min/max. Update = scatter-add; merge = elementwise sum
  (min/min, max/max).
- **HyperLogLog**: ``m = 2^p`` rank registers, standard error ``~1.04/sqrt(m)``,
  with the small-range linear-counting correction. Update = scatter-max;
  merge = elementwise max.
- **Count-min + top-k candidate ledger**: a ``depth x width`` table (update
  scatter-add, merge sum) and a ``(k, 2)`` ledger of ``[key, estimate]`` rows
  walked item by item; the ledger merges by :func:`topk_merge`.

Item identity is the 32-bit pattern of the value (floats by their float32
bits, ints by their int32 two's-complement value; an int64 is cut to its low
32 bits, as the JAX package does with 64-bit mode off), mixed through the
murmur3 finalizer. Heavy-hitter ids must be non-negative int32 (``-1`` marks
an empty ledger slot).

Where the JAX package hashes on uint32 lanes, the port hashes on int64 lanes
that hold the uint32 value (PyTorch has no right shift of uint32), and every
multiply is taken in 16-bit halves so that no int64 product overflows: the
bits are the JAX package's, on the CPU and on the card. :func:`hash32`
returns those int64 lanes.

The DDSketch bucket scatter-add and the HLL register scatter-max dispatch
through the kernel registry under the JAX names ``ddsketch_hist_add`` /
``hll_scatter_max``: the CUDA kernels of ``csrc/scatter.cu`` on CUDA tensors,
the plain versions on CPU tensors. The count-min table update
(:func:`cms_table_update`) takes the registry entry ``cms_row_scatter`` on
the CPU and, on the card, the ids route of the same kernel, which hashes the
columns itself (see there). The ledger walk of :func:`cms_update` (a
``lax.scan`` in the JAX package, with no Pallas body) is one launch of the
CUDA kernel ``csrc/cms_walk.cu`` on the card and a plain loop over the batch
on the CPU (:mod:`metrics_tpu_torch.kernels.cms_walk`): each replacement
decision reads the count-min estimate including its own item's increment, a
sequential dependency no batched scatter can honour. Neither reads a tensor
value on the host, so on the card they only enqueue.
"""

from __future__ import annotations

import math
from typing import Any, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.kernels import cms_walk, scatter
from metrics_tpu_torch.kernels import registry as _kernel_registry  # the package registers every entry

__all__ = [
    "cms_query",
    "cms_table_update",
    "cms_update",
    "ddsketch_params",
    "ddsketch_quantiles",
    "ddsketch_update",
    "hash32",
    "hh_rank",
    "hll_estimate",
    "hll_update",
    "topk_merge",
]


# --------------------------------------------------------------------- hashing

_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLD = 0x9E3779B9
_MASK32 = 0xFFFFFFFF


def _f32(x: float) -> float:
    """``x`` rounded to float32, so a Python scalar enters float32 arithmetic
    as ``jnp.float32(x)`` does."""
    return float(np.float32(x))


def _mix32_py(x: int) -> int:
    """Host-side murmur3 finalizer (static seed derivation)."""
    x &= _MASK32
    x ^= x >> 16
    x = (x * _M1) & _MASK32
    x ^= x >> 13
    x = (x * _M2) & _MASK32
    x ^= x >> 16
    return x


def _mul32(x: Tensor, m: int) -> Tensor:
    """``(x * m) mod 2**32`` on int64 lanes holding uint32 values, in 16-bit
    halves of ``x`` so that no product exceeds 2**49."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * m + (((hi * m) & 0xFFFF) << 16)) & _MASK32


def _mix32(x: Tensor) -> Tensor:
    """murmur3 finalizer on int64 lanes holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def _as_uint32_bits(values: Any) -> Tensor:
    """Canonical 32-bit identity of a value, as int64 lanes in ``[0, 2**32)``:
    the float32 bit pattern for floats, two's-complement int32 for ints and
    bools. Cross-dtype identity is by bit pattern: ``1`` and ``1.0`` differ."""
    x = torch.as_tensor(values)
    if x.is_floating_point():
        x = x.to(torch.float32).view(torch.int32)
    return x.to(torch.int64) & _MASK32


def hash32(values: Any, seed: int = 0) -> Tensor:
    """Well-mixed 32-bit hash of each element (see :func:`_as_uint32_bits`),
    as int64 lanes holding the uint32 value."""
    return _mix32(_as_uint32_bits(values) ^ _mix32_py(seed ^ _GOLD))


def _clz32(x: Tensor) -> Tensor:
    """Branchless count-leading-zeros of uint32 values held in int64 lanes, as int32."""
    x = x & _MASK32
    n = torch.full_like(x, 32)
    for s in (16, 8, 4, 2, 1):
        y = x >> s
        big = y != 0
        n = torch.where(big, n - s, n)
        x = torch.where(big, y, x)
    return (n - x).to(torch.int32)


# --------------------------------------------------------------------- DDSketch


def ddsketch_params(alpha: float, min_trackable: float = 1e-8) -> Tuple[float, float, int]:
    """``(gamma, log_gamma, offset)`` for a target relative error ``alpha``.

    ``gamma`` is derived from ``a = 0.995·alpha``: the 0.5% shrink keeps the
    bucket-midpoint estimate within the user's alpha even when float32 log
    rounding lands a boundary value one bucket off. ``offset`` shifts bucket 0
    to ``min_trackable``.
    """
    if not 0.0 < alpha < 1.0:
        raise ValueError(f"`alpha` must be in (0, 1), got {alpha}")
    if not min_trackable > 0.0:
        raise ValueError(f"`min_trackable` must be > 0, got {min_trackable}")
    a = 0.995 * float(alpha)
    gamma = (1.0 + a) / (1.0 - a)
    log_gamma = math.log(gamma)
    offset = -int(math.ceil(math.log(min_trackable) / log_gamma))
    return gamma, log_gamma, offset


def ddsketch_buckets(v: Tensor, n_buckets: int, *, log_gamma: float, offset: int) -> Tensor:
    """The int32 bucket index of each float32 value.

    ``ceil(log(|v|) / log_gamma) + offset`` in float32, clipped to the stores.
    The log and the int cast only ever see finite positive magnitudes: ±inf
    goes straight to the top bucket (the exact min/max carry it), and zero
    and NaN get an index that their zero weights never use.
    """
    absv = torch.abs(v)
    finite = torch.isfinite(v)
    safe = torch.where((absv > 0) & finite, absv, 1.0)
    idx = torch.ceil(torch.log(safe) * _f32(1.0 / log_gamma)).to(torch.int32) + offset
    idx = torch.clamp(idx, 0, n_buckets - 1)
    return torch.where(finite, idx, n_buckets - 1)


def ddsketch_update(
    pos: Tensor,
    neg: Tensor,
    zero: Tensor,
    vmin: Tensor,
    vmax: Tensor,
    values: Any,
    *,
    log_gamma: float,
    offset: int,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Scatter one batch of values into the log-bucket stores.

    NaNs contribute nothing; exact zeros land in ``zero``. An empty batch
    returns the state as it was.
    """
    v = torch.as_tensor(values, device=pos.device).reshape(-1).to(torch.float32)
    if v.numel() == 0:
        return pos, neg, zero, vmin, vmax
    idx = ddsketch_buckets(v, pos.shape[0], log_gamma=log_gamma, offset=offset)
    pos = _kernel_registry.dispatch("ddsketch_hist_add", pos, idx, (v > 0).to(pos.dtype))
    neg = _kernel_registry.dispatch("ddsketch_hist_add", neg, idx, (v < 0).to(neg.dtype))
    zero = zero + (v == 0).sum(dtype=zero.dtype)
    not_nan = ~torch.isnan(v)
    vmin = torch.minimum(vmin, torch.where(not_nan, v, math.inf).min())
    vmax = torch.maximum(vmax, torch.where(not_nan, v, -math.inf).max())
    return pos, neg, zero, vmin, vmax


def ddsketch_quantiles(
    pos: Tensor,
    neg: Tensor,
    zero: Tensor,
    vmin: Tensor,
    vmax: Tensor,
    quantiles: Sequence[float],
    *,
    gamma: float,
    offset: int,
) -> Tensor:
    """Quantile estimates (one per ``q``) from the bucket stores.

    Walks [reversed negative store, zero bucket, positive store] by cumulative
    rank (int32); the bucket-midpoint estimate is clipped to the exact observed
    ``[vmin, vmax]``, and q = 0 / 1 answer the exact extremes. An empty sketch
    gives NaN per quantile.
    """
    n_buckets = pos.shape[0]
    device = pos.device
    i = torch.arange(n_buckets, dtype=torch.float32, device=device)
    est = _f32(2.0 / (gamma + 1.0)) * torch.exp((i - _f32(offset)) * _f32(math.log(gamma)))
    counts = torch.cat([neg.flip(0), zero.reshape(1).to(neg.dtype), pos])
    values = torch.cat([-est.flip(0), torch.zeros(1, dtype=torch.float32, device=device), est])
    cum = torch.cumsum(counts, 0, dtype=torch.int32)
    total = cum[-1]
    qs = torch.tensor(tuple(quantiles), dtype=torch.float32, device=device)
    ranks = qs * (total - 1).to(torch.float32)
    # jnp.searchsorted promotes the int32 ranks table against float32 ranks to float32
    picked = torch.searchsorted(cum.to(torch.float32), ranks, right=True)
    out = values[torch.clamp(picked, 0, counts.shape[0] - 1)]
    out = torch.minimum(vmax, torch.maximum(vmin, out))  # jnp.clip(out, vmin, vmax)
    out = torch.where(qs <= 0.0, vmin, torch.where(qs >= 1.0, vmax, out))
    return torch.where(total > 0, out, math.nan)


# --------------------------------------------------------------------- HyperLogLog


def hll_update(registers: Tensor, values: Any, *, p: int) -> Tensor:
    """Scatter-max each value's leading-zero rank into its register.

    The top ``p`` hash bits pick the register; the other ``32-p`` bits give
    rank ``clz+1`` (capped at ``32-p+1`` when they are all zero).
    """
    v = torch.as_tensor(values, device=registers.device).reshape(-1)
    if v.numel() == 0:
        return registers
    idx, rank = hll_registers(v, p=p)
    return _kernel_registry.dispatch("hll_scatter_max", registers, idx, rank.to(registers.dtype))


def hll_registers(values: Tensor, *, p: int) -> Tuple[Tensor, Tensor]:
    """``(register, rank)`` of each value, both int32: the scatter-max that
    :func:`hll_update` dispatches."""
    h = hash32(values)
    idx = (h >> (32 - p)).to(torch.int32)
    rank = torch.clamp(_clz32((h << p) & _MASK32) + 1, max=32 - p + 1)
    return idx, rank


def hll_estimate(registers: Tensor) -> Tensor:
    """Bias-corrected harmonic-mean estimate with linear-counting fallback (float32)."""
    m = registers.shape[0]
    if m == 16:
        alpha = 0.673
    elif m == 32:
        alpha = 0.697
    elif m == 64:
        alpha = 0.709
    else:
        alpha = 0.7213 / (1.0 + 1.079 / m)
    harm = torch.sum(torch.exp2(-registers.to(torch.float32)))
    raw = _f32(alpha * m * m) / harm
    zeros = (registers == 0).sum().to(torch.float32)
    linear = _f32(m) * torch.log(_f32(m) / torch.clamp(zeros, min=1.0))
    return torch.where((raw <= 2.5 * m) & (zeros > 0), linear, raw)


# ----------------------------------------------------------- count-min + top-k


def _row_seeds(depth: int) -> np.ndarray:
    """Static per-row hash seeds (identical across processes by construction)."""
    return np.asarray([_mix32_py((j + 1) * _GOLD) for j in range(depth)], np.uint32)


def _cm_columns(ids: Tensor, depth: int, width: int) -> Tensor:
    """Per-row column index of each id: int32 of shape ``(*ids.shape, depth)``."""
    seeds = torch.from_numpy(_row_seeds(depth).astype(np.int64)).to(ids.device)
    h = _mix32(_as_uint32_bits(ids)[..., None] ^ seeds)
    return (h % width).to(torch.int32)


def cms_update(counts: Tensor, ledger: Tensor, values: Any) -> Tuple[Tensor, Tensor]:
    """One batch through the count-min table AND the top-k candidate ledger.

    Item by item, in order: the item's count-min cells are incremented, then
    an item already in the ledger refreshes its count to the count-min
    estimate; otherwise it evicts the first minimum slot iff its estimate
    exceeds that slot's count. Empty slots are ``[-1, 0]``, so they go first.
    A negative id is invalid and changes nothing. ``counts`` and ``ledger``
    are left as they were. One launch of the walk kernel on the card
    (:func:`metrics_tpu_torch.kernels.cms_walk.cms_walk_cuda`), the plain loop
    on the CPU.
    """
    ids = torch.as_tensor(values, device=counts.device).reshape(-1).to(torch.int32).contiguous()
    if ids.numel() == 0:
        return counts, ledger
    return cms_walk.cms_walk_cuda(counts, ledger, ids)


def cms_table_update(counts: Tensor, values: Any) -> Tensor:
    """Bulk count-min TABLE update: no candidate ledger, one batched scatter.

    Bit-identical to the counts of :func:`cms_update` on the same batch
    (integer adds commute). On a CUDA tensor this is one launch of the ids
    route of ``cms_rows_add`` (:func:`metrics_tpu_torch.kernels.scatter.cms_ids_add_cuda`),
    which hashes each id's columns in registers: no ``(N, depth)`` column
    array is written and read back, and the hash is not the ~30 elementwise
    int64 passes of :func:`_cm_columns`. That route does not go through the
    registry entry ``cms_row_scatter``, whose contract (columns in, as in the
    JAX package) it cannot keep; on the CPU the update hashes with
    :func:`_cm_columns` and dispatches ``cms_row_scatter`` as the JAX package
    does.
    """
    ids = torch.as_tensor(values, device=counts.device).reshape(-1).to(torch.int32).contiguous()
    if ids.numel() == 0:
        return counts
    if counts.device.type == "cuda":
        return scatter.cms_ids_add_cuda(counts, ids)
    depth, width = counts.shape
    cols = _cm_columns(ids, depth, width)  # (N, depth)
    valid = ids >= 0  # negative ids are invalid (the ledger's sentinel) everywhere
    return _kernel_registry.dispatch("cms_row_scatter", counts, cols, valid)


def cms_query(counts: Tensor, keys: Any) -> Tensor:
    """Count-min point estimate per key (0 for the ``-1`` empty-slot marker).

    Never underestimates a true count.
    """
    depth, width = counts.shape
    ids = torch.as_tensor(keys, device=counts.device).to(torch.int32)
    cols = _cm_columns(ids, depth, width).to(torch.int64)  # (..., depth)
    est = counts[torch.arange(depth, device=counts.device), cols].amin(dim=-1)
    return torch.where(ids >= 0, est, 0)


def _lexsort_desc(keys: Tensor, score: Tensor) -> Tensor:
    """``jnp.lexsort((keys, score))[::-1]``: descending by score, then by key,
    as two stable sorts (by key, then by score), reversed."""
    by_key = torch.argsort(keys, stable=True)
    return by_key[torch.argsort(score[by_key], stable=True)].flip(0)


def hh_rank(counts: Tensor, ledger: Tensor) -> Tuple[Tensor, Tensor]:
    """The heavy-hitter answer: every ledger candidate re-estimated against the
    count-min table, sorted by estimate descending (ties broken by key).
    Returns ``(keys, counts)``; ``-1``/``0`` pad unused slots."""
    keys = ledger[:, 0]
    est = cms_query(counts, keys)
    score = torch.where(keys >= 0, est, -1)
    order = _lexsort_desc(keys, score)
    live = score[order] >= 0
    return torch.where(live, keys[order], -1), torch.where(live, est[order], 0)


def topk_merge(stacked: Tensor) -> Tensor:
    """Merge ``(..., k, 2)`` stacked candidate ledgers into one ``(k, 2)`` ledger.

    Union of candidates, per-key count sum over every occurrence, top-k by
    ``(count, key)`` descending. Keys are unique after the union, so the result
    does not depend on operand order: the merge is commutative bit for bit.
    This is the ``dist_reduce_fx`` that ``merge_states`` calls with ``(2, k, 2)``.
    """
    led = torch.as_tensor(stacked)
    k = led.shape[-2]
    flat = led.reshape(-1, 2)
    keys, cnts = flat[:, 0], flat[:, 1]
    valid = keys >= 0
    cnts = torch.where(valid, cnts, 0)
    same = (keys[:, None] == keys[None, :]) & valid[:, None] & valid[None, :]
    tot = torch.where(same, cnts[None, :], 0).sum(dim=1, dtype=cnts.dtype)
    dup = torch.tril(same, -1).any(dim=1)  # a later occurrence of an earlier key
    score = torch.where(valid & ~dup, tot, -1)
    order = _lexsort_desc(keys, score)[:k]
    live = score[order] > 0
    out_keys = torch.where(live, keys[order], -1)
    out_cnts = torch.where(live, score[order], 0)
    return torch.stack([out_keys, out_cnts], dim=1).to(led.dtype)
