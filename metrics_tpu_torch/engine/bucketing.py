"""Shape-bucketed padding of incoming requests (port of ``metrics_tpu/engine/bucketing.py``).

A serving process receives requests of arbitrary row counts. Coalesced request
rows are padded up to a small fixed set of bucket sizes with a boolean row
mask, so the engine captures one CUDA graph per bucket (per request signature
and tenant capacity) and every later micro-batch replays a captured graph.

Padded rows are *carried but never applied*: the masked scan
(:mod:`metrics_tpu_torch.kernels.engine_scan`) keeps every tenant's state out
of their reach, so padding contributes exactly zero to every tenant's state.

Signatures use the dtypes the JAX package sees with x64 off: int64 becomes
int32, float64 float32 (and uint64 uint32, complex128 complex64). A numpy-int64
client and an int32 client then share one graph; the padded columns hold the
narrowed values, and the port's kernels count class labels by their low 32
bits anyway.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

# Default micro-batch row buckets. Small buckets keep padding waste low for trickle
# traffic; the largest bounds one dispatch's work under burst load.
DEFAULT_BUCKETS: Tuple[int, ...] = (8, 16, 32, 64, 128, 256)

# (trailing shape, dtype name) per positional arg — the graph-cache-relevant part of a
# request's shape, i.e. everything except the bucketed leading (row) axis.
Signature = Tuple[Tuple[Tuple[int, ...], str], ...]

# one micro-batch as the host built it: (columns, key_ids, mask) in numpy
HostBatch = Tuple[List[np.ndarray], np.ndarray, np.ndarray]


@dataclass(frozen=True)
class BucketConfig:
    """The engine's micro-batch ladder as an explicit config object.

    ``ladder`` is the set of row sizes the engine captures graphs for. The
    default stays the log2 ladder (:data:`DEFAULT_BUCKETS`); a deployment with
    a recorded request-size trace can hand :func:`tune_buckets` output here
    instead, trading generic coverage for measured-traffic padding efficiency
    at the same graph-cache bound.
    """

    ladder: Tuple[int, ...] = DEFAULT_BUCKETS

    def normalized(self) -> Tuple[int, ...]:
        return normalize_buckets(self.ladder)


def normalize_buckets(buckets: Union[Sequence[int], BucketConfig]) -> Tuple[int, ...]:
    """Sorted, deduplicated, validated bucket sizes (accepts a BucketConfig)."""
    if isinstance(buckets, BucketConfig):
        buckets = buckets.ladder
    sizes = sorted({int(b) for b in buckets})
    if not sizes or sizes[0] < 1:
        raise MetricsTPUUserError(f"`buckets` must be positive integers, got {buckets!r}")
    return tuple(sizes)


def tune_buckets(
    measured_occupancy: Union[Iterable[int], Mapping[int, float]],
    *,
    max_buckets: int = len(DEFAULT_BUCKETS),
    max_rows: int = DEFAULT_BUCKETS[-1],
) -> Tuple[int, ...]:
    """Pick a bucket ladder from measured occupancy instead of log2 guessing.

    ``measured_occupancy`` is a recorded request-size trace: an iterable of
    observed per-request row counts (what the engine's batch-occupancy
    telemetry measures — ``telemetry.snapshot()['rows']`` per request, or a
    replayed submit log), or a pre-aggregated ``{rows: weight}`` mapping.

    Minimizes total padded rows over the trace subject to at most
    ``max_buckets`` graphs per signature, by exact dynamic programming over the
    distinct observed sizes (bucket boundaries only ever pay off ON an
    observed size): ``cost(i..j) = Σ w_k · (s_j − s_k)`` for sizes ``s_i..s_j``
    assigned to bucket ``s_j``. Sizes above ``max_rows`` are clamped — the
    engine splits oversized requests into ``max_rows`` chunks anyway
    (:func:`split_rows`), so the ladder never needs a rung above the cap.
    Returns the ladder ready for ``BucketConfig(ladder=...)``; empty traces
    return :data:`DEFAULT_BUCKETS` unchanged.
    """
    if int(max_buckets) < 1:
        raise MetricsTPUUserError(f"`max_buckets` must be >= 1, got {max_buckets}")
    weights: Dict[int, float] = {}
    if isinstance(measured_occupancy, Mapping):
        items: Iterable[Tuple[int, float]] = measured_occupancy.items()
    else:
        items = ((int(r), 1.0) for r in measured_occupancy)
    for rows, w in items:
        rows = int(rows)
        if rows < 1 or w <= 0:
            continue
        rows = min(rows, int(max_rows))
        weights[rows] = weights.get(rows, 0.0) + float(w)
    if not weights:
        return DEFAULT_BUCKETS
    sizes = sorted(weights)
    # bound the DP: past ~512 distinct sizes, collapse to a WEIGHT-quantile
    # grid — grid points are spent where the traffic mass is (a dominant size
    # always lands on itself), not uniformly over the distinct-size range.
    # Each size keeps its weight on the grid point at or above it, so the
    # padding-cost model stays an upper bound of the true cost.
    if len(sizes) > 512:
        w_sorted = np.asarray([weights[s] for s in sizes], dtype=np.float64)
        cum = np.cumsum(w_sorted)
        picks = np.searchsorted(cum, np.linspace(0.0, cum[-1], 512), side="left")
        grid = sorted({int(sizes[min(int(p), len(sizes) - 1)]) for p in picks} | {sizes[-1]})
        collapsed: Dict[int, float] = {}
        gi = 0
        for s in sizes:
            while grid[gi] < s:
                gi += 1
            collapsed[grid[gi]] = collapsed.get(grid[gi], 0.0) + weights[s]
        weights = collapsed
        sizes = sorted(weights)
    m = len(sizes)
    k_max = min(int(max_buckets), m)
    w = np.asarray([weights[s] for s in sizes], dtype=np.float64)
    s = np.asarray(sizes, dtype=np.float64)
    # cost[i, j]: padded rows when sizes i..j all round up to bucket s_j
    cum_w = np.concatenate([[0.0], np.cumsum(w)])
    cum_ws = np.concatenate([[0.0], np.cumsum(w * s)])

    def seg_cost(i: int, j: int) -> float:
        return s[j] * (cum_w[j + 1] - cum_w[i]) - (cum_ws[j + 1] - cum_ws[i])

    inf = float("inf")
    dp = np.full((k_max + 1, m), inf)
    parent = np.full((k_max + 1, m), -1, dtype=np.int64)
    for j in range(m):
        dp[1, j] = seg_cost(0, j)
    for b in range(2, k_max + 1):
        for j in range(b - 1, m):
            for i in range(b - 2, j):
                c = dp[b - 1, i] + seg_cost(i + 1, j)
                if c < dp[b, j]:
                    dp[b, j] = c
                    parent[b, j] = i
    # the top bucket must cover the largest observed size; fewer buckets than
    # max_buckets win automatically when extra rungs stop paying
    best_b = min(range(1, k_max + 1), key=lambda b: dp[b, m - 1])
    ladder: List[int] = []
    b, j = best_b, m - 1
    while j >= 0 and b >= 1:
        ladder.append(sizes[j])
        j = int(parent[b, j])
        b -= 1
    return tuple(sorted(ladder))


# the dtypes the JAX package canonicalises to with x64 off
_NARROW = {"int64": "int32", "uint64": "uint32", "float64": "float32", "complex128": "complex64"}


def narrow_name(name: str) -> str:
    """The dtype name the JAX package sees for ``name`` with x64 off."""
    return _NARROW.get(name, name)


def _dtype_name(a: Any) -> str:
    if isinstance(a, torch.Tensor):
        return str(a.dtype).replace("torch.", "")
    return np.dtype(a.dtype).name


def _as_numpy(a: Any) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def as_request_tensor(a: Any, device: Any) -> torch.Tensor:
    """One request argument as a tensor on ``device`` in the signature's dtype
    (64-bit types narrowed): how the eager paths apply a request whole, with
    the values the padded columns would hold."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, copy=True))
    name = _dtype_name(t)
    if name in _NARROW:
        t = torch.from_numpy(_as_numpy(t).astype(_NARROW[name]))
    return t.to(device)


def inspect_request(args: Sequence[Any]) -> Tuple[int, Signature]:
    """Row count and shape signature of one request's positional arrays.

    Every arg must share the leading (row) axis — that is the axis the engine
    coalesces, masks and buckets over. Arrays may be numpy arrays, tensors or
    anything ``np.asarray`` takes.
    """
    if not args:
        raise MetricsTPUUserError("submit() needs at least one array argument")
    rows = None
    sig: List[Tuple[Tuple[int, ...], str]] = []
    for a in args:
        arr = a if isinstance(a, (torch.Tensor, np.ndarray)) else np.asarray(a)
        if arr.ndim < 1:
            raise MetricsTPUUserError(
                "submit() arguments must have a leading batch axis (got a 0-d array); "
                "wrap scalars as shape-(1,) arrays"
            )
        if rows is None:
            rows = int(arr.shape[0])
        elif int(arr.shape[0]) != rows:
            raise MetricsTPUUserError(
                f"submit() arguments disagree on the leading axis: {rows} vs {int(arr.shape[0])}"
            )
        # canonical dtype, not the submitted one: pad_micro_batch narrows the
        # columns as the JAX package's jnp.asarray does — a numpy-int64 client and
        # an int32 client submitting identical data share one graph
        name = _dtype_name(arr)
        sig.append((tuple(int(s) for s in arr.shape[1:]), _NARROW.get(name, name)))
    return rows, tuple(sig)


def choose_bucket(rows: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits ``rows`` (deterministic); the largest if none does.

    Callers split loads larger than the top bucket into several micro-batches, so
    returning the cap here keeps the choice total.
    """
    for b in buckets:
        if rows <= b:
            return b
    return buckets[-1]


def pad_micro_batch(
    requests: Sequence[Tuple[int, Sequence[Any], int]],
    bucket: int,
    device: Any = "cpu",
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor, HostBatch]:
    """Assemble one padded micro-batch from coalesced requests.

    ``requests`` is a sequence of ``(slot, args, rows)`` triples whose total rows fit
    ``bucket``. Rows are laid out back-to-back in submission order (the masked scan
    walks them in this order, preserving per-tenant sequential semantics); the tail is
    zero-padded and masked out. Returns ``(columns, key_ids, mask, host)``: the first
    three on ``device``, where each column has shape ``(bucket, 1, *trailing)`` and the
    narrowed dtype of the request signature — the per-row scan slice keeps a leading
    batch axis of 1 so a metric's ``update_state`` sees an ordinary (tiny) batch;
    ``key_ids`` is int32, ``mask`` bool. Each column is built on the host and sent to
    ``device`` in one copy; ``host`` holds those numpy arrays, ``(columns, key_ids,
    mask)``, from which the engine journals the micro-batch without reading the card.

    Padding rows carry the first request's slot id: it is always a valid index into the
    stacked state (so the masked gather/scatter stays in bounds) and the mask guarantees
    it is never applied.
    """
    total = sum(r for _, _, r in requests)
    if total > bucket:
        raise MetricsTPUUserError(f"micro-batch of {total} rows exceeds bucket {bucket}")
    n_args = len(requests[0][1])
    key_ids = np.full(bucket, requests[0][0], dtype=np.int32)
    mask = np.zeros(bucket, dtype=bool)
    columns: List[np.ndarray] = []
    for j in range(n_args):
        ref = requests[0][1][j]
        ref = ref if isinstance(ref, (torch.Tensor, np.ndarray)) else np.asarray(ref)
        name = _dtype_name(ref)
        col = np.zeros((bucket, 1) + tuple(ref.shape[1:]), dtype=_NARROW.get(name, name))
        off = 0
        for slot, args, rows in requests:
            col[off : off + rows, 0] = _as_numpy(args[j])
            if j == 0:
                key_ids[off : off + rows] = slot
                mask[off : off + rows] = True
            off += rows
        columns.append(col)
    dev = torch.device(device)
    return (
        [torch.from_numpy(c).to(dev) for c in columns],
        torch.from_numpy(key_ids).to(dev),
        torch.from_numpy(mask).to(dev),
        (columns, key_ids, mask),
    )


def split_rows(args: Sequence[Any], max_rows: int) -> List[Tuple[Sequence[Any], int]]:
    """Split one oversized request into row-chunks of at most ``max_rows``.

    Engine semantics are per-row streaming updates (see runtime.py), so chunking a
    request along rows is exact for the supported metric class.
    """
    rows, _ = inspect_request(args)
    if rows <= max_rows:
        return [(tuple(args), rows)]
    out: List[Tuple[Sequence[Any], int]] = []
    for lo in range(0, rows, max_rows):
        hi = min(lo + max_rows, rows)
        out.append((tuple(a[lo:hi] for a in args), hi - lo))
    return out
