"""``RetrievalMetric``: the whole-batch group-by-query compute (port of
``metrics_tpu/retrieval/base.py``).

No loop over queries on the host. One lexicographic sort by (query, −score)
orders every document of every query: torch has no ``lexsort``, so it is two
STABLE sorts, the minor key (the score) first, which keeps tied scores of a
query in their input order as ``jnp.lexsort`` keeps them. Within-query ranks
and cumulative hits come from ``cumsum`` over the sorted arrays; per-query
sums and minima are ``index_add_`` and ``scatter_reduce_(..., "amin")`` over
the dense query ids. On the card a float
``index_add_`` adds in no fixed order, so a per-query sum of non-integer
terms (average precision, nDCG) may differ from the CPU's in its last bits;
counts of 0/1 targets are exact. The number of queries, ``int(seg[-1]) + 1``,
is the one value the compute reads on the host (the JAX package's too), with
the "error" action's check and a curve's default ``max_k``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.checks import _check_retrieval_inputs
from metrics_tpu_torch.utils.data import dim_zero_cat


def _lexsort(minor: Tensor, major: Tensor) -> Tensor:
    """The permutation that sorts by ``major``, then ``minor``, both ascending,
    ties in input order (``jnp.lexsort((minor, major))``)."""
    order = torch.argsort(minor, stable=True)
    return order[torch.argsort(major[order], stable=True)]


@dataclass
class GroupedRanks:
    """Every per-document and per-query array a ranked-retrieval metric needs.

    Sorted order is (query ascending, score descending). ``seg`` maps each
    document to a dense query id in [0, num_queries); ``rank`` is the 0-based
    position of the document in its query's ranking.
    """

    seg: Tensor          # (N,) int64 dense query ids, sorted
    rank: Tensor         # (N,) int64 within-query rank by descending score
    preds: Tensor        # (N,) float32, sorted
    target: Tensor       # (N,) float32, sorted by (query, -score)
    n_per: Tensor        # (Q,) float32 documents a query
    pos_per: Tensor      # (Q,) float32 sum of the targets (gains) a query
    neg_per: Tensor      # (Q,) float32 zero or negative targets a query
    cum_hits: Tensor     # (N,) float32 inclusive within-query cumsum of the target
    num_queries: int
    # the unsorted inputs, kept so ideal_target can be derived on demand
    indexes_raw: Tensor
    target_raw: Tensor
    _ideal_cache: Optional[Tensor] = None

    @property
    def ideal_target(self) -> Tensor:
        """(N,) float32 gains sorted by (query, −target): the ideal ranking of
        nDCG. Lazy, as only nDCG needs this second sort."""
        if self._ideal_cache is None:
            ideal_order = _lexsort(-self.target_raw.to(torch.float32), self.indexes_raw)
            self._ideal_cache = self.target_raw[ideal_order].to(torch.float32)
        return self._ideal_cache

    def segment_sum(self, x: Tensor) -> Tensor:
        return torch.zeros(self.num_queries, dtype=x.dtype, device=x.device).index_add_(0, self.seg, x)

    def segment_min(self, x: Tensor) -> Tensor:
        out = torch.zeros(self.num_queries, dtype=x.dtype, device=x.device)
        return out.scatter_reduce_(0, self.seg, x, "amin", include_self=False)

    def k_mask(self, k: Optional[Tensor]) -> Tensor:
        """(N,) float32 mask of the documents with rank < k (k a query or one k; None: all)."""
        if k is None:
            return torch.ones_like(self.rank, dtype=torch.float32)
        k_per_doc = k[self.seg] if getattr(k, "ndim", 0) == 1 else k
        return (self.rank < k_per_doc).to(torch.float32)


def group_by_query(indexes: Tensor, preds: Tensor, target: Tensor) -> GroupedRanks:
    """:class:`GroupedRanks` from flat ``(indexes, preds, target)``."""
    n = preds.shape[0]
    dev = preds.device
    order = _lexsort(-preds, indexes)
    idx_s = indexes[order]
    preds_s = preds[order]
    tgt_s = target[order].to(torch.float32)

    new = torch.ones(n, dtype=torch.bool, device=dev)
    torch.ne(idx_s[1:], idx_s[:-1], out=new[1:])
    seg = torch.cumsum(new, dim=0) - 1
    num_queries = int(seg[-1]) + 1 if n else 0

    def per_query(x: Tensor) -> Tensor:
        return torch.zeros(num_queries, dtype=x.dtype, device=dev).index_add_(0, seg, x)

    # each document's query starts at the exclusive prefix sum of the queries'
    # sizes (scans over the whole array, not torch.cummax, whose CUDA scan of
    # one long row runs in one block)
    sizes = per_query(torch.ones(n, dtype=torch.int64, device=dev))
    start = (torch.cumsum(sizes, dim=0) - sizes)[seg]
    rank = torch.arange(n, device=dev) - start

    # within-query inclusive cumsum: the global cumsum less its value before the
    # query's first document (the JAX package reads that value with cummax,
    # which gives the same for the non-negative targets of every metric that
    # reads cum_hits)
    pre = torch.cumsum(tgt_s, dim=0)
    cum_hits = pre - (pre - tgt_s)[start]

    return GroupedRanks(
        seg=seg,
        rank=rank,
        preds=preds_s,
        target=tgt_s,
        n_per=sizes.to(torch.float32),
        pos_per=per_query(tgt_s),
        neg_per=per_query((tgt_s <= 0).to(torch.float32)),
        cum_hits=cum_hits,
        num_queries=num_queries,
        indexes_raw=indexes,
        target_raw=target,
    )


class RetrievalMetric(Metric):
    """Base of the retrieval metrics.

    A subclass implements :meth:`_query_values`, one value a query; this base
    validates the inputs, keeps the list states, groups the documents by
    query and applies ``empty_target_action`` ("neg", "pos", "skip" or
    "error") to the queries with no positive target (for fall-out, no
    negative one). Compute runs on the whole sample (``_host_compute``),
    eagerly on the states' own device.
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = True
    full_state_update: bool = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    _host_compute = True

    allow_non_binary_target: bool = False
    # which per-query count must be non-zero for a query to count as non-empty
    _empty_on: str = "positives"

    indexes: List[Tensor]
    preds: List[Tensor]
    target: List[Tensor]

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)

        if empty_target_action not in ("error", "skip", "neg", "pos"):
            raise ValueError(f"Argument `empty_target_action` received a wrong value `{empty_target_action}`.")
        self.empty_target_action = empty_target_action

        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError("Argument `ignore_index` must be an integer or None.")
        self.ignore_index = ignore_index

        self.add_state("indexes", default=[], dist_reduce_fx="cat")
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor, indexes: Tensor) -> None:
        if indexes is None:
            raise ValueError("Argument `indexes` cannot be None")
        indexes, preds, target = _check_retrieval_inputs(
            indexes, preds, target, allow_non_binary_target=self.allow_non_binary_target, ignore_index=self.ignore_index
        )
        self.indexes.append(indexes)
        self.preds.append(preds)
        self.target.append(target)

    def _grouped(self) -> GroupedRanks:
        return group_by_query(dim_zero_cat(self.indexes), dim_zero_cat(self.preds), dim_zero_cat(self.target))

    def _valid(self, groups: GroupedRanks) -> Tensor:
        return (groups.pos_per if self._empty_on == "positives" else groups.neg_per) > 0

    def _raise_on_empty(self, valid: Tensor) -> None:
        if bool(torch.any(~valid)):
            kind = "positive" if self._empty_on == "positives" else "negative"
            raise ValueError(f"`compute` method was provided with a query with no {kind} target.")

    def compute(self) -> Tensor:
        groups = self._grouped()
        values = self._query_values(groups)
        valid = self._valid(groups)

        if self.empty_target_action == "error":
            self._raise_on_empty(valid)
            mask = torch.ones_like(valid)
        elif self.empty_target_action == "pos":
            values = torch.where(valid, values, 1.0)
            mask = torch.ones_like(valid)
        elif self.empty_target_action == "neg":
            values = torch.where(valid, values, 0.0)
            mask = torch.ones_like(valid)
        else:  # skip
            mask = valid

        count = mask.sum().to(torch.float32)
        total = torch.where(mask, values, 0.0).sum()
        return torch.where(count > 0, total / torch.clamp(count, min=1.0), 0.0).to(torch.float32)

    def _query_values(self, groups: GroupedRanks) -> Tensor:
        """The metric's value for every query, a (Q,) tensor."""
        raise NotImplementedError
