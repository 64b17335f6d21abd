"""The heavy-hitter ledger walk of the sketch plane (port of the ``lax.scan`` in
``metrics_tpu/sketch/kernels.py::cms_update``, which has no Pallas body).

For each id ``x`` of a batch, in order (``valid``: ``x >= 0``): the id's
``depth`` count-min cells gain ``valid``; ``est`` is the minimum over those
cells after the add; every ledger slot whose key is ``x`` raises its count to
``max(count, est)``; otherwise, if ``x`` is valid and ``est`` is above the
smallest count, the first slot with the smallest count becomes ``[x, est]``.
The ledger is ``(k, 2)`` int32 rows ``[key, count]``, ``[-1, 0]`` when empty.

It comes three ways:

- :func:`cms_walk_reference`: the plain PyTorch version, one item at a time
  (about 18 small launches an item on the card). Serves CPU tensors.
- :func:`cms_walk_cuda`: the wrapper of the CUDA kernels ``csrc/cms_walk.cu``,
  four launches per batch (the estimates across the card in three, the walk
  in one), bit-identical to the plain version. On a CPU tensor it is the
  plain version; on a CUDA tensor it launches the kernels on the current
  stream or raises.
- :func:`walk_in_chunks`: the kernels' own order of work in numpy (segment
  ranks and a scan for the estimates; steps of 512 items, or of 32 for
  k > 32, with a snapshot of the keys, raises applied in any order between
  evictions, each candidate decided exactly), for the CPU tests and the
  card's checks.

Every tensor stays where it is: no call reads a value on the host. Under
``torch.func.vmap`` :func:`cms_walk_cuda` takes a batched call through its
custom op ``metrics_tpu_torch::cms_walk``, whose rule calls the wrapper once a
copy (:mod:`._batched`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.kernels import _batched, _build, _tally
from metrics_tpu_torch.kernels.scatter import (
    CMS_MAX_DEPTH,
    MAX_CUDA_SIZE,
    _check_table,
    _flat_int32,
    _require_cuda,
    ids_route_columns,
)
from metrics_tpu_torch.obs import instrument as _obs

KERNEL_NAME = "cms_walk"  # csrc/cms_walk.cu
MAX_SLOTS = 2**30 - 1  # ledger slots: the (k, 2) ledger is indexed within int32 range
CHUNK = 32  # items one warp takes together; k > 32: the walk's step
STEP = 512  # k <= 32: items the walk's sixteen warps take together
KERNELS = 4  # kernels one call launches: histograms, scan, estimates, walk
SEGMENT_IDS = 1024  # ids per estimate segment, at least
SEGMENT_CELLS = 2**22  # histogram cells of all segments together, at most, unless one table is larger
MAX_SEGMENTS = 1024

# Kernels launched by ``cms_walk_cuda``, counted where it launches them (KERNELS a call).
launches = 0


class WalkCounts(NamedTuple):
    """What :func:`walk_in_chunks` counts on its way (the first three are the
    kernel's counters)."""

    raises: int  # valid items whose key the ledger held at their time
    evictions: int  # items that took a slot
    sequential_chunks: int  # chunks of 32 items that held a candidate, an item the walk decided exactly
    snapshot_items: int  # valid items held at their step's start or with an estimate above its smallest count then


def segments(n: int, cells: int) -> int:
    """How many segments of consecutive ids the estimates cut a batch of ``n``
    ids into, for a table of ``cells`` cells (one histogram row each)."""
    return max(1, min(-(-n // SEGMENT_IDS), SEGMENT_CELLS // cells, MAX_SEGMENTS))


def cms_walk_reference(counts: Tensor, ledger: Tensor, ids: Tensor) -> Tuple[Tensor, Tensor]:
    """The walk, one item at a time. ``counts`` and ``ledger`` are left as
    they were; the outputs are new tensors."""
    from metrics_tpu_torch.sketch.kernels import _cm_columns  # the sketch plane imports this module

    depth, width = counts.shape
    k = ledger.shape[0]
    ids = ids.reshape(-1).to(torch.int32)
    device = counts.device
    # every item's flat (depth,) cells, hashed in one batch: the same columns
    # the JAX scan hashes one item at a time
    cells = _cm_columns(ids, depth, width).to(torch.int64) + torch.arange(depth, device=device) * width
    valid = ids >= 0
    inc = valid.to(counts.dtype)[:, None].expand(-1, depth).contiguous()  # (N, depth)
    slot = torch.arange(k, device=device)
    counts = counts.clone(memory_format=torch.contiguous_format)
    flat = counts.view(-1)  # updated in place: this clone is the function's own
    keys, cnts = ledger[:, 0], ledger[:, 1]
    for n in range(ids.shape[0]):
        x, ok, at = ids[n], valid[n], cells[n]
        flat.index_add_(0, at, inc[n])  # one kernel (an accumulating index_put_ sorts first on the card)
        est = flat[at].min()
        present = (keys == x) & ok
        cnts = torch.where(present, torch.maximum(cnts, est), cnts)
        # cnts[argmin(cnts)] is cnts.min(); argmin takes the first minimum, as jnp.argmin does
        evict = ok & ~present.any() & (est > cnts.min())
        sel = (slot == torch.argmin(cnts)) & evict
        keys = torch.where(sel, x, keys)
        cnts = torch.where(sel, est, cnts)
    return counts, torch.stack([keys, cnts], dim=1)


def _wrap32(x: np.ndarray) -> np.ndarray:
    return ((x + 2**31) % 2**32 - 2**31).astype(np.int64)


def _rank_among_earlier(key: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """For each valid item, how many earlier valid items share its key (0 for
    an invalid one)."""
    rank = np.zeros(key.shape[0], np.int64)
    idx = np.flatnonzero(valid)
    order = np.argsort(key[idx], kind="stable")
    ks = key[idx][order]
    pos = np.arange(ks.shape[0])
    start = np.maximum.accumulate(np.where(np.r_[True, ks[1:] != ks[:-1]], pos, 0)) if ks.shape[0] else pos
    rank[idx[order]] = pos - start
    return rank


def estimates(table: np.ndarray, x: np.ndarray, cols: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The new table and every item's estimate, as the first three kernels
    compute them: per segment a histogram of its valid ids per cell, an
    exclusive scan of the histograms over the segments (the count of a cell
    before a segment), and an item's rank among its segment's earlier valid
    items on each cell. ``table``: (depth, width) int32; ``x``: (N,) int32
    ids; ``cols``: (N, depth) columns. Both results are int64 holding int32
    values (the int32 wrap of the sequential adds)."""
    depth, width = table.shape
    n, n_cells = x.shape[0], depth * width
    valid = x >= 0
    cells = np.arange(depth, dtype=np.int64) * width + cols.astype(np.int64)  # (N, depth)
    n_seg = segments(n, n_cells)
    seg = np.arange(n, dtype=np.int64) // -(-n // n_seg)
    hist = np.zeros((n_seg, n_cells), np.int64)
    np.add.at(hist, (np.repeat(seg[valid], depth), cells[valid].reshape(-1)), 1)
    flat = table.reshape(-1).astype(np.int64)
    before = flat + np.cumsum(hist, axis=0) - hist  # each segment's table as it starts
    est = np.full(n, 2**31 - 1, np.int64)
    for j in range(depth):
        c = cells[:, j]
        rank = _rank_among_earlier(seg * n_cells + c, valid)
        est = np.minimum(est, _wrap32(before[seg, c] + rank + 1))
    return _wrap32(flat + hist.sum(axis=0)).reshape(depth, width), est


def walk_step(k: int) -> int:
    """The items the walk kernel takes together for a ledger of ``k`` slots."""
    return STEP if k <= CHUNK else CHUNK


def walk_in_chunks(counts: Tensor, ledger: Tensor, ids: Tensor,
                   step: Optional[int] = None) -> Tuple[Tensor, Tensor, WalkCounts]:
    """The walk in the kernels' order of work, on CPU tensors.

    The estimates come from :func:`estimates`. Then steps of ``step`` items
    (default :func:`walk_step`): the held flags come from a snapshot of the
    keys; a candidate is a valid item not held whose estimate is above the
    smallest count. The raises of the held items before the first candidate
    are applied at once, in no order (a maximum per slot); the candidate is
    decided exactly (argmin's first slot); after an eviction the held flags of
    the later items are taken anew; and so on to the end of the step. Returns
    the table, the ledger and the counts of :class:`WalkCounts`; the ledger
    and the first two counts do not depend on ``step``.
    """
    step = walk_step(ledger.shape[0]) if step is None else step
    x = ids.reshape(-1).to(torch.int32).numpy()
    table, est = estimates(counts.numpy(), x, ids_route_columns(ids, *counts.shape).numpy())
    keys = ledger[:, 0].numpy().astype(np.int32).copy()
    cnts = ledger[:, 1].numpy().astype(np.int64).copy()
    raises = evictions = snapshot = 0
    decided = set()  # the chunks of 32 that held a candidate
    for base in range(0, x.shape[0], step):
        xs, es = x[base:base + step], est[base:base + step]
        valid = xs >= 0
        held = valid & np.isin(xs, keys)
        snapshot += int((held | (valid & (es > cnts.min()))).sum())
        lane = 0
        while lane < xs.shape[0]:
            rest = np.arange(lane, xs.shape[0])
            cand = rest[valid[rest] & ~held[rest] & (es[rest] > cnts.min())]
            stop = int(cand[0]) if cand.size else xs.shape[0]
            up = lane + np.flatnonzero(held[lane:stop])
            if up.size:  # max-raises on fixed keys: any order gives this
                raises += up.size
                hit = keys[None, :] == xs[up, None]
                cnts = np.maximum(cnts, np.where(hit, es[up, None], np.iinfo(np.int64).min).max(axis=0))
            if not cand.size:
                break
            decided.add((base + stop) // CHUNK)
            if es[stop] > cnts.min():
                s = int(np.argmin(cnts))
                keys[s], cnts[s] = xs[stop], es[stop]
                evictions += 1
                held = valid & np.isin(xs, keys)
            lane = stop + 1
    out = np.stack([keys, cnts.astype(np.int32)], axis=1)
    return (torch.from_numpy(table.astype(np.int32)), torch.from_numpy(out),
            WalkCounts(raises, evictions, len(decided), snapshot))


# --------------------------------------------------------------------- CUDA wrapper


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL_NAME)
    if not getattr(lib, "_argtypes_set", False):
        lib.cms_walk_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.cms_walk_launch.restype = ctypes.c_int
        lib.cms_walk_placement.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.cms_walk_placement.restype = ctypes.c_int
        lib.cms_walk_error_string.argtypes = [ctypes.c_int]
        lib.cms_walk_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def placement(depth: int, width: int, k: int) -> str:
    """Where the kernels keep their state for this shape on the current CUDA
    device: ``"histograms <shared|global>, ledger <...>"``, the ledger in
    shared memory for the step walk (k <= 32), or in shared or global memory
    for the one-warp walk. Builds the kernels if needed."""
    bits = _lib().cms_walk_placement(depth, width, k)
    if bits < 0:
        raise RuntimeError(f"cms_walk_placement: CUDA error {-bits}")
    led = "shared, step walk" if bits & 4 else ("shared, one warp" if bits & 2 else "global, one warp")
    return f"histograms {'shared' if bits & 1 else 'global'}, ledger {led}"


def cms_walk_cuda(
    counts: Tensor, ledger: Tensor, ids: Tensor, counters: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor]:
    """:func:`cms_walk_reference` by the CUDA kernels ``csrc/cms_walk.cu``.

    On a CPU tensor this is the plain version (``counters`` unused). On a
    CUDA tensor the kernels are launched on the current stream or the call
    raises: on another device, a table that is not 2-D int32, more than
    ``CMS_MAX_DEPTH`` rows, a ledger that is not ``(k, 2)`` int32 with
    ``1 <= k <= MAX_SLOTS``, non-integer or non-contiguous ids, N >= 2**31,
    or a launch error. ``counters``, a 3-element int64 tensor on the table's
    device, gains the first three counts of :class:`WalkCounts` (raises,
    evictions, chunks of 32 that held a candidate). The working memory (the
    estimates and the segment histograms) comes from one ``torch.empty``.
    """
    global launches
    if _batched.is_batched(counts, ledger, ids, counters):
        if counters is not None:
            raise ValueError("cms_walk_cuda: counters are not taken in a batched call")
        return _cms_walk_op(counts, ledger, ids)
    if counts.device.type == "cpu":
        return cms_walk_reference(counts, ledger, ids)
    what = "cms_walk_cuda"
    _check_table(what, counts, 2)
    depth, width = counts.shape
    if depth > CMS_MAX_DEPTH:
        raise ValueError(f"{what}: depth {depth} is above CMS_MAX_DEPTH = {CMS_MAX_DEPTH}")
    device = counts.device
    if ledger.device != device:
        raise ValueError(f"{what}: ledger is on {ledger.device}, the table on {device}")
    if ledger.dtype != torch.int32 or ledger.dim() != 2 or ledger.shape[1] != 2:
        raise TypeError(f"{what}: the ledger must be a (k, 2) int32 tensor, got {tuple(ledger.shape)} {ledger.dtype}")
    k = ledger.shape[0]
    if not 1 <= k <= MAX_SLOTS:
        raise ValueError(f"{what}: a ledger of {k} slots is out of range [1, {MAX_SLOTS}]")
    i = _flat_int32(what, "ids", ids, device)
    n = i.numel()
    if n > MAX_CUDA_SIZE:
        raise ValueError(f"{what}: N = {n} >= 2**31 is not supported")
    if counters is not None and (counters.device != device or counters.dtype != torch.int64
                                 or counters.numel() != 3 or not counters.is_contiguous()):
        raise ValueError(f"{what}: counters must be 3 contiguous int64 on {device}: one int64 for each count")
    _require_cuda(what, device)
    if n == 0:
        return counts.clone(memory_format=torch.contiguous_format), ledger.clone(memory_format=torch.contiguous_format)
    counts_in, ledger_in = counts.contiguous(), ledger.contiguous()
    out_counts = torch.empty((depth, width), dtype=torch.int32, device=device)
    out_ledger = torch.empty((k, 2), dtype=torch.int32, device=device)
    n_seg = segments(n, depth * width)
    scratch = torch.empty(-(-n // 4) * 4 + n_seg * depth * width, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = _lib().cms_walk_launch(
            i.data_ptr(), n, depth, width, counts_in.data_ptr(), ledger_in.data_ptr(), k, n_seg,
            scratch.data_ptr(), out_counts.data_ptr(), out_ledger.data_ptr(),
            counters.data_ptr() if counters is not None else None, stream,
        )
    if code != 0:
        msg = _lib().cms_walk_error_string(code).decode()
        raise _build.KernelLaunchError(f"cms_walk CUDA kernel failed to launch: {msg} (error {code})")
    launches += KERNELS
    _tally.record(KERNEL_NAME, KERNELS)
    for _ in range(KERNELS):
        _obs.record_kernel_launch(KERNEL_NAME)
    return out_counts, out_ledger


@torch.library.custom_op("metrics_tpu_torch::cms_walk", mutates_args=())
def _cms_walk_op(counts: Tensor, ledger: Tensor, ids: Tensor) -> Tuple[Tensor, Tensor]:
    """:func:`cms_walk_cuda` as a custom op: the route of a batched call."""
    return cms_walk_cuda(counts, ledger, ids)


@_cms_walk_op.register_fake
def _(counts, ledger, ids):
    return (torch.empty_like(counts, memory_format=torch.contiguous_format),
            torch.empty_like(ledger, memory_format=torch.contiguous_format))


_cms_walk_op.register_vmap(_batched.loop_rule(cms_walk_cuda))
