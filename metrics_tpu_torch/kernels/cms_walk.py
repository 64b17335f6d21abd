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
- :func:`cms_walk_cuda`: the wrapper of the CUDA kernel ``csrc/cms_walk.cu``,
  one launch per batch, bit-identical to the plain version. On a CPU tensor it
  is the plain version; on a CUDA tensor it launches the kernel on the current
  stream or raises.
- :func:`walk_in_chunks`: the kernel's own order of work in numpy (chunks of
  32 items, estimates from ranks, decisions only where the ledger can
  change), for the CPU tests.

Every tensor stays where it is: no call reads a value on the host.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.kernels import _build
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
CHUNK = 32  # items whose estimates the kernel takes together: one warp

# Launches of the CUDA kernel, counted by ``cms_walk_cuda`` where it launches.
launches = 0


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


def walk_in_chunks(counts: Tensor, ledger: Tensor, ids: Tensor) -> Tuple[Tensor, Tensor, int]:
    """The walk in the kernel's order of work, on CPU tensors.

    Chunks of 32 items. Per row, the valid items of a chunk that share a cell
    each get the cell's count before the chunk, plus their rank among the
    chunk's earlier items on that cell, plus one; the cell gains the group's
    size. An item's estimate is the minimum over its rows. Then, in order,
    only the valid items whose key the ledger held at the start of the chunk,
    or whose estimate is above its smallest count then, reach the sequential
    decision. Returns the table, the ledger and the number of items that
    reached the decision.
    """
    table = counts.numpy().astype(np.int32).copy()
    depth, width = table.shape
    flat = table.reshape(-1)
    keys = ledger[:, 0].numpy().astype(np.int32).copy()
    cnts = ledger[:, 1].numpy().astype(np.int64).copy()
    x = ids.reshape(-1).to(torch.int32).numpy()
    cols = ids_route_columns(ids, depth, width).numpy().astype(np.int64)
    decided = 0
    for base in range(0, x.shape[0], CHUNK):
        xs, cs = x[base:base + CHUNK], cols[base:base + CHUNK]
        valid = xs >= 0
        est = np.full(xs.shape[0], 2**31 - 1, np.int64)
        for j in range(depth):
            cell = j * width + cs[:, j]
            same = (cell[:, None] == cell[None, :]) & valid[None, :]
            rank = np.tril(same, -1).sum(axis=1)  # earlier valid lanes on the same cell
            est = np.minimum(est, _wrap32(flat[cell].astype(np.int64) + rank + 1))
            np.add.at(flat, cell[valid], np.int32(1))
        held = np.isin(xs, keys)
        todo = np.flatnonzero(valid & (held | (est > cnts.min())))
        decided += todo.size
        for i in todo:
            present = keys == xs[i]
            if present.any():
                cnts = np.where(present, np.maximum(cnts, est[i]), cnts)
            elif est[i] > cnts.min():
                s = int(np.argmin(cnts))
                keys[s], cnts[s] = xs[i], est[i]
    out = np.stack([keys.astype(np.int32), cnts.astype(np.int32)], axis=1)
    return torch.from_numpy(table), torch.from_numpy(out), decided


# --------------------------------------------------------------------- CUDA wrapper


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL_NAME)
    if not getattr(lib, "_argtypes_set", False):
        lib.cms_walk_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.cms_walk_launch.restype = ctypes.c_int
        lib.cms_walk_placement.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.cms_walk_placement.restype = ctypes.c_int
        lib.cms_walk_error_string.argtypes = [ctypes.c_int]
        lib.cms_walk_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def placement(depth: int, width: int, k: int) -> str:
    """Where the kernel keeps its state for this shape on the current CUDA
    device: ``"table <shared|global>, ledger <registers|shared|global>"``.
    Builds the kernel if needed."""
    bits = _lib().cms_walk_placement(depth, width, k)
    if bits < 0:
        raise RuntimeError(f"cms_walk_placement: CUDA error {-bits}")
    led = "registers" if bits & 4 else ("shared" if bits & 2 else "global")
    return f"table {'shared' if bits & 1 else 'global'}, ledger {led}"


def cms_walk_cuda(
    counts: Tensor, ledger: Tensor, ids: Tensor, decisions: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor]:
    """:func:`cms_walk_reference` by the CUDA kernel ``csrc/cms_walk.cu``.

    On a CPU tensor this is the plain version (``decisions`` unused). On a
    CUDA tensor the kernel is launched once on the current stream or the call
    raises: on another device, a table that is not 2-D int32, more than
    ``CMS_MAX_DEPTH`` rows, a ledger that is not ``(k, 2)`` int32 with
    ``1 <= k <= MAX_SLOTS``, non-integer or non-contiguous ids, N >= 2**31,
    or a launch error. ``decisions``, a one-element int64 tensor on the
    table's device, gains the number of items that reached the kernel's
    sequential ledger decision.
    """
    global launches
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
    if decisions is not None and (decisions.device != device or decisions.dtype != torch.int64
                                  or decisions.numel() != 1):
        raise ValueError(f"{what}: decisions must be one int64 on {device}")
    _require_cuda(what, device)
    out_counts = counts.clone(memory_format=torch.contiguous_format)
    out_ledger = ledger.clone(memory_format=torch.contiguous_format)
    if n == 0:
        return out_counts, out_ledger
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = _lib().cms_walk_launch(
            i.data_ptr(), n, depth, width, k, out_counts.data_ptr(), out_ledger.data_ptr(),
            decisions.data_ptr() if decisions is not None else None, stream,
        )
    if code != 0:
        msg = _lib().cms_walk_error_string(code).decode()
        raise RuntimeError(f"cms_walk CUDA kernel failed to launch: {msg} (error {code})")
    launches += 1
    _obs.record_kernel_launch(KERNEL_NAME)
    return out_counts, out_ledger
