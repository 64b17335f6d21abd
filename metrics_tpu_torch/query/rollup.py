"""Partition rollups — every local tenant folded into ONE mergeable state
(port of ``metrics_tpu/query/rollup.py``).

The fold is the vectorised analogue of repeated
:meth:`~metrics_tpu_torch.metric.Metric.merge_states` over all tenants,
computed as one slab-axis reduction per leaf instead of K-1 pairwise merges:

- ``sum`` states reduce with ``torch.sum`` over the tenant axis in the
  state's own dtype (``torch.sum`` of int32 would return int64; the JAX
  package keeps int32 with x64 off) — bit-identical to any pairwise merge
  order for the integer states every sketch family carries (DDSketch
  buckets, HLL registers, CMS tables are all int32);
- ``min`` / ``max`` states reduce elementwise (``torch.amin`` /
  ``torch.amax``) — exact in any order;
- ``mean`` states reduce as one ``_update_count``-weighted sum (the same
  formula ``merge_states`` applies pairwise; for floating-point states the
  single weighted sum and a nested pairwise merge can differ in rounding —
  both are within each other's accumulation error, and the port's sum and
  the JAX package's may add in other orders: float32, rtol 1e-6);
- callable reductions take the WHOLE ``(K, ...)`` stack in one call — the
  :func:`~metrics_tpu_torch.sketch.kernels.topk_merge` contract, whose merge
  is commutative bit-for-bit and exactly associative while the candidate
  union fits the ledger.

Free and never-dispatched slab rows hold init values, which are the identity
elements of their reductions (zero counts, ``+inf`` mins, ``-inf`` maxes,
``-1``-keyed empty ledgers, zero ``_update_count``), so the fold runs over
the whole slab without masking: an evicted row contributes nothing, and an
empty partition's rollup is exactly the merge identity. Every reduction is
a torch op on the slab's device: on the card a fold only enqueues.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import reduce as _reduce
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from metrics_tpu_torch.query.errors import RollupUnsupported

__all__ = ["PartitionRollup", "fold_slab", "fold_states", "merge_folds"]


@dataclass(frozen=True)
class PartitionRollup:
    """One partition's tenants folded into one state, stamped for the cache.

    ``watermark`` is the serving engine's ``(epoch, seq)`` WAL position in the
    same dispatch-lock window the fold was enqueued in, so the rollup is
    exactly "the fold of everything journaled through seq, in lineage epoch".
    ``follower`` / ``staleness_*`` record WHERE it was served — the
    bounded-staleness evidence the query report surfaces per-partition.
    """

    partition: str
    state: Dict[str, Any]
    watermark: Tuple[int, int]
    tenants: int
    follower: bool = False
    node: str = ""
    staleness_seqs: Optional[int] = None
    staleness_s: Optional[float] = None


def _fold_leaf(name: str, reduction: Any, rows: torch.Tensor, weights: torch.Tensor,
               total: torch.Tensor) -> torch.Tensor:
    if reduction == "sum":
        return torch.sum(rows, dim=0, dtype=rows.dtype)
    if reduction == "max":
        return torch.amax(rows, dim=0)
    if reduction == "min":
        return torch.amin(rows, dim=0)
    if reduction == "mean":
        weighted = weights.reshape(weights.shape + (1,) * (rows.ndim - 1)) * rows
        return torch.sum(weighted, dim=0, dtype=weighted.dtype) / torch.clamp(total, min=1)
    if callable(reduction):
        # singleton pass-through, exactly like a pairwise reduce over one
        # state: reduction callables may canonicalize representation (e.g.
        # topk_merge re-sorts the ledger), and a fold of ONE state must be
        # that state bit-for-bit to stay interchangeable with merge_states
        # (a copy: the engine's slab is written in place, so a view of its one
        # row would change under later replays)
        return rows[0].clone() if rows.shape[0] == 1 else reduction(rows)
    raise RollupUnsupported(
        f"state {name!r} has dist_reduce_fx={reduction!r}: a rollup is a fixed-size "
        "mergeable summary, and 'cat'/None states grow with the stream — use a "
        "sketch-family metric or a reducible scalar state"
    )


def fold_slab(metric: Any, slab: Dict[str, Any]) -> Dict[str, Any]:
    """Fold a stacked ``(K, ...)``-per-leaf state slab into one state dict."""
    counts = torch.as_tensor(slab["_update_count"])
    total = torch.sum(counts, dtype=counts.dtype)
    out: Dict[str, Any] = {}
    for name, reduction in metric._reductions.items():
        rows = slab[name]
        if isinstance(rows, list):
            raise RollupUnsupported(
                f"state {name!r} is a list state: not foldable into a rollup"
            )
        out[name] = _fold_leaf(name, reduction, torch.as_tensor(rows), counts, total)
    out["_update_count"] = total
    return out


def _count(value: Any, device: Any) -> torch.Tensor:
    """An ``_update_count`` as a tensor; a Python int becomes int32, as
    ``jnp.asarray`` makes it with x64 off."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.as_tensor(value, dtype=torch.int32, device=device)


def fold_states(metric: Any, states: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold individually-held state dicts (eager / tiered tenants) by stacking
    them into a transient slab and reducing it exactly as :func:`fold_slab`
    does — one semantics for both storage regimes."""
    states = list(states)
    if not states:
        return metric.init_state()
    for name in metric._reductions:
        if any(isinstance(s[name], list) for s in states):
            raise RollupUnsupported(
                f"state {name!r} is a list state: not foldable into a rollup"
            )
    slab: Dict[str, Any] = {
        name: torch.stack([torch.as_tensor(s[name]) for s in states])
        for name in metric._reductions
    }
    device = next(iter(slab.values())).device if slab else None
    slab["_update_count"] = torch.stack([_count(s.get("_update_count", 0), device) for s in states])
    return fold_slab(metric, slab)


def merge_folds(metric: Any, folds: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge already-folded states left-to-right (ring segments oldest-first
    into the live fold, then tiered tenants) via ``merge_states``."""
    folds = list(folds)
    if not folds:
        return metric.init_state()
    return _reduce(metric.merge_states, folds)
