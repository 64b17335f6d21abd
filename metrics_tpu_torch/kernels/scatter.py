"""Scatter kernels of the sketch plane (port of ``metrics_tpu/kernels/scatter.py``).

Every sketch update is an int32 scatter:

- ``hist_add``: ``bins[i] += sum of w`` over the samples with ``idx == i``
  (the DDSketch bucket stores);
- ``hist_max``: ``bins[i] = max(bins[i], max of v)`` over the samples with
  ``idx == i`` (the HyperLogLog rank registers);
- ``cms_rows_add``: ``counts[j, cols[n, j]] += valid[n]`` for every depth row
  ``j`` (the count-min table). Its kernel takes the columns from two sources:
  a ``(N, depth)`` array (``cms_rows_add_cuda``, the registry entry), or ids
  hashed inside the kernel (``cms_ids_add_cuda``, the ids route that
  ``sketch.kernels.cms_table_update`` calls on the card: one launch per
  update, and no ``(N, depth)`` array in device memory).

Indices outside ``[0, B)`` contribute nothing. Each comes three ways:

- ``*_reference``: the plain PyTorch version (``index_add`` /
  ``scatter_reduce``), with the same masking as the JAX references. Serves
  CPU tensors.
- ``*_cuda``: the wrapper of the CUDA kernel ``csrc/scatter.cu``, which
  replaces the Pallas ``_scatter_kernel``. On a CPU tensor it is the plain
  version; on a CUDA tensor it launches the kernel on the current stream or
  raises.
- the registry entries ``ddsketch_hist_add``, ``hll_scatter_max`` and
  ``cms_row_scatter``, under the JAX names, which the sketch kernels dispatch.

Eligibility is every ``0 <= N < 2**31`` for any table of ``1 <= B < 2**31``
int32 bins. The JAX package's batch-size floor (``MIN_SCATTER_SIZE = 1024``)
is not carried over: it chose XLA's scatter over the Pallas kernel for small
batches on the TPU, a speed choice and not part of the contract, and the
port's registry raises on an ineligible CUDA call, so a floor would make every
small sketch update on the card an error. Integer add (modulo 2**32) and max
commute, so the kernel is bit-identical to the plain version in any launch
order. Nothing catches a kernel failure. Under ``torch.func.vmap`` each
``*_cuda`` wrapper takes a batched call through its custom op
(``metrics_tpu_torch::hist_add``, ``::hist_max``, ``::cms_rows_add``,
``::cms_ids_add``), whose rule calls the wrapper once a copy (:mod:`._batched`).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.kernels import _batched, _build, _tally, registry
from metrics_tpu_torch.obs import instrument as _obs

KERNEL_NAME = "scatter"  # csrc/scatter.cu
MAX_CUDA_SIZE = 2**31 - 1  # N and the table size are indexed within int32 range
_INT32_MIN = -(2**31)

CMS_MAX_DEPTH = 4096  # count-min rows a kernel takes: their hash seeds sit in shared memory

# Launches of each CUDA kernel, counted by its wrapper where it launches
# (``cms_rows_add`` by both of its column sources).
launches: Dict[str, int] = {"hist_add": 0, "hist_max": 0, "cms_rows_add": 0}

_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)


# --------------------------------------------------------------------- plain versions


def _valid_index(idx: Tensor, n_bins: int) -> Tuple[Tensor, Tensor]:
    i = idx.reshape(-1).to(torch.int64)
    valid = (i >= 0) & (i < n_bins)
    return torch.where(valid, i, 0), valid


def hist_add_reference(bins: Tensor, idx: Tensor, weights: Tensor) -> Tensor:
    """``bins`` plus ``weights`` scattered-added at ``idx``; out-of-range indices dropped."""
    i, valid = _valid_index(idx, bins.shape[0])
    w = weights.reshape(-1).to(bins.dtype)
    return bins.index_add(0, i, torch.where(valid, w, 0))


def hist_max_reference(bins: Tensor, idx: Tensor, values: Tensor) -> Tensor:
    """``bins`` maxed with ``values`` scattered at ``idx``; out-of-range indices dropped."""
    i, valid = _valid_index(idx, bins.shape[0])
    v = values.reshape(-1).to(bins.dtype)
    return bins.scatter_reduce(0, i, torch.where(valid, v, _INT32_MIN), "amax", include_self=True)


def cms_rows_add_reference(counts: Tensor, cols: Tensor, valid: Tensor) -> Tensor:
    """``counts[j, cols[:, j]] += valid`` for every depth row ``j``.

    Columns outside ``[0, width)`` are dropped, as the kernels drop them (the
    JAX reference's ``.at[rows, cols].add`` would wrap a negative column;
    ``_cm_columns`` never makes one).
    """
    depth, width = counts.shape
    c = cols.reshape(-1, depth).to(torch.int64)
    inc = valid.reshape(-1, 1).to(counts.dtype).expand(c.shape)
    ok = (c >= 0) & (c < width)
    key = torch.where(ok, torch.arange(depth, device=counts.device) * width + c, 0)
    flat = counts.reshape(-1).index_add(0, key.reshape(-1), torch.where(ok, inc, 0).reshape(-1))
    return flat.reshape(depth, width)


def cms_ids_add_reference(counts: Tensor, ids: Tensor) -> Tensor:
    """``counts[j, column(id, j)] += 1`` for every ``id >= 0`` and depth row
    ``j``: ``sketch.kernels._cm_columns`` and :func:`cms_rows_add_reference`."""
    from metrics_tpu_torch.sketch.kernels import _cm_columns  # the sketch plane imports this module

    depth, width = counts.shape
    i = ids.reshape(-1).to(torch.int32)
    return cms_rows_add_reference(counts, _cm_columns(i, depth, width), i >= 0)


_GOLD = 0x9E3779B9


def _mix32_u32(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def ids_route_columns(ids: Tensor, depth: int, width: int) -> Tensor:
    """The ``(N, depth)`` int32 columns as ``csrc/cm_hash.cuh`` computes them,
    in its own arithmetic: uint32 lanes, the row seed ``mix32((j + 1) *
    0x9E3779B9)`` wrapped in 32 bits, ``% width`` (a mask for a power of two).
    For CPU tensors; the CPU tests hold it against the JAX package's
    ``_cm_columns``."""
    x = ids.reshape(-1).to(torch.int32).numpy().view(np.uint32)
    with np.errstate(over="ignore"):
        seeds = _mix32_u32(np.arange(1, depth + 1, dtype=np.uint32) * np.uint32(_GOLD))
        h = _mix32_u32(x[:, None] ^ seeds[None, :])
    col = h & np.uint32(width - 1) if width & (width - 1) == 0 else h % np.uint32(width)
    return torch.from_numpy(col.astype(np.int32))


# --------------------------------------------------------------------- CUDA wrappers


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL_NAME)
    if not getattr(lib, "_argtypes_set", False):
        for fn in (lib.hist_add_launch, lib.hist_max_launch):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.cms_rows_add_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.cms_rows_add_launch.restype = ctypes.c_int
        lib.cms_ids_add_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.cms_ids_add_launch.restype = ctypes.c_int
        lib.scatter_cms_ids_shared.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.scatter_cms_ids_shared.restype = ctypes.c_int
        lib.scatter_uses_shared.argtypes = [ctypes.c_longlong]
        lib.scatter_uses_shared.restype = ctypes.c_int
        lib.scatter_hist_branch.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
        lib.scatter_hist_branch.restype = ctypes.c_int
        lib.scatter_error_string.argtypes = [ctypes.c_int]
        lib.scatter_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def uses_shared_branch(n_cells: int) -> bool:
    """True when a table of ``n_cells`` int32 takes the kernels' shared-memory
    branch on the current CUDA device (builds the kernels if needed)."""
    code = _lib().scatter_uses_shared(n_cells)
    if code < 0:
        raise RuntimeError(f"scatter_uses_shared: CUDA error {-code}")
    return bool(code)


HIST_BRANCHES = ("global", "shared", "packed")


def hist_branch(kernel: str, n: int, n_bins: int) -> str:
    """The branch ``kernel`` (``"hist_add"`` or ``"hist_max"``) takes on the
    current CUDA device for ``n`` samples into ``n_bins`` bins: ``"shared"`` (a
    private table per block), ``"packed"`` (hist_max: int16 slots, a table up
    to twice a block's int32 slots, N >= B) or ``"global"`` (global atomics).
    Builds the kernels if needed."""
    code = _lib().scatter_hist_branch(n, n_bins, int(kernel == "hist_max"))
    if code < 0:
        raise RuntimeError(f"scatter_hist_branch: CUDA error {-code}")
    return HIST_BRANCHES[code]


def cms_ids_branch(depth: int, width: int) -> str:
    """The branch the ids route of ``cms_rows_add`` takes on the current CUDA
    device for a ``depth x width`` table: ``"shared"`` (a private table per
    block, beside the row seeds) or ``"global"`` (global atomics). Builds the
    kernels if needed."""
    code = _lib().scatter_cms_ids_shared(depth, width)
    if code < 0:
        raise RuntimeError(f"scatter_cms_ids_shared: CUDA error {-code}")
    return "shared" if code else "global"


def _flat_int32(what: str, name: str, x: Tensor, device: torch.device, allow_bool: bool = False) -> Tensor:
    if x.device != device:
        raise ValueError(f"{what}: {name} is on {x.device}, the table on {device}")
    if x.dtype not in _INT_DTYPES and not (allow_bool and x.dtype == torch.bool):
        raise TypeError(f"{what}: {name} must be an integer tensor, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")
    return x.reshape(-1).to(torch.int32)


def _check_table(what: str, table: Tensor, ndim: int) -> None:
    if table.dtype != torch.int32 or table.dim() != ndim:
        raise TypeError(f"{what}: the table must be a {ndim}-D int32 tensor, got {table.dim()}-D {table.dtype}")
    if not 1 <= table.numel() <= MAX_CUDA_SIZE:
        raise ValueError(f"{what}: a table of {table.numel()} cells is out of range")


def _require_cuda(what: str, device: torch.device) -> None:
    """Checked after the shapes, so that the CPU tests reach every check on ``meta`` tensors."""
    if device.type != "cuda":
        raise ValueError(f"{what}: tensors must lie on a CUDA device or the CPU, got {device}")


def _raise_on(code: int, kernel: str) -> None:
    if code != 0:
        msg = _lib().scatter_error_string(code).decode()
        raise _build.KernelLaunchError(f"{kernel} CUDA kernel failed to launch: {msg} (error {code})")


def _counted(kernel: str) -> None:
    launches[kernel] += 1
    _tally.record(kernel)
    _obs.record_kernel_launch(kernel)


def _hist_cuda(kernel: str, bins: Tensor, idx: Tensor, values: Tensor) -> Tensor:
    what = f"{kernel}_cuda"
    _check_table(what, bins, 1)
    device = bins.device
    i = _flat_int32(what, "idx", idx, device)
    v = _flat_int32(what, "values", values, device, allow_bool=True)
    n = i.numel()
    if v.numel() != n:
        raise ValueError(f"{what}: idx has {n} elements, values {v.numel()}")
    if n > MAX_CUDA_SIZE:
        raise ValueError(f"{what}: N = {n} >= 2**31 is not supported")
    _require_cuda(what, device)
    out = bins.clone(memory_format=torch.contiguous_format)
    if n == 0:
        return out
    launch = _lib().hist_add_launch if kernel == "hist_add" else _lib().hist_max_launch
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = launch(i.data_ptr(), v.data_ptr(), n, bins.shape[0], out.data_ptr(), stream)
    _raise_on(code, kernel)
    _counted(kernel)
    return out


def hist_add_cuda(bins: Tensor, idx: Tensor, weights: Tensor) -> Tensor:
    """:func:`hist_add_reference` by the CUDA kernel ``csrc/scatter.cu``.

    On a CPU tensor this is the plain version. On a CUDA tensor the kernel is
    launched on the current stream (no synchronisation) or the call raises: on
    another device, a table that is not 1-D int32, a non-integer or
    non-contiguous input, mismatched lengths, N >= 2**31, or a launch error.
    """
    if _batched.is_batched(bins, idx, weights):
        return _hist_add_op(bins, idx, weights)
    if bins.device.type == "cpu":
        return hist_add_reference(bins, idx, weights)
    return _hist_cuda("hist_add", bins, idx, weights)


def hist_max_cuda(bins: Tensor, idx: Tensor, values: Tensor) -> Tensor:
    """:func:`hist_max_reference` by the CUDA kernel ``csrc/scatter.cu``
    (the same rules as :func:`hist_add_cuda`)."""
    if _batched.is_batched(bins, idx, values):
        return _hist_max_op(bins, idx, values)
    if bins.device.type == "cpu":
        return hist_max_reference(bins, idx, values)
    return _hist_cuda("hist_max", bins, idx, values)


def cms_rows_add_cuda(counts: Tensor, cols: Tensor, valid: Tensor) -> Tensor:
    """:func:`cms_rows_add_reference` by the CUDA kernel ``csrc/scatter.cu``:
    all depth rows in one launch (the same rules as :func:`hist_add_cuda`;
    ``cols`` is ``(N, depth)``, ``valid`` ``(N,)`` bool or integer)."""
    if _batched.is_batched(counts, cols, valid):
        return _cms_rows_add_op(counts, cols, valid)
    if counts.device.type == "cpu":
        return cms_rows_add_reference(counts, cols, valid)
    what = "cms_rows_add_cuda"
    _check_table(what, counts, 2)
    device = counts.device
    depth, width = counts.shape
    if cols.dim() != 2 or cols.shape[1] != depth:
        raise ValueError(f"{what}: cols must be (N, {depth}), got {tuple(cols.shape)}")
    c = _flat_int32(what, "cols", cols, device)
    n = cols.shape[0]
    if valid.device != device:
        raise ValueError(f"{what}: valid is on {valid.device}, the table on {device}")
    if valid.numel() != n or not valid.is_contiguous():
        raise ValueError(f"{what}: valid must be a contiguous tensor of {n} elements")
    flat = valid.reshape(-1)
    flags = flat.view(torch.uint8) if flat.dtype == torch.bool else (flat != 0).to(torch.uint8)
    if n > MAX_CUDA_SIZE:
        raise ValueError(f"{what}: N = {n} >= 2**31 is not supported")
    _require_cuda(what, device)
    out = counts.clone(memory_format=torch.contiguous_format)
    if n == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = _lib().cms_rows_add_launch(c.data_ptr(), flags.data_ptr(), n, depth, width, out.data_ptr(), stream)
    _raise_on(code, "cms_rows_add")
    _counted("cms_rows_add")
    return out


def cms_ids_add_cuda(counts: Tensor, ids: Tensor) -> Tensor:
    """:func:`cms_ids_add_reference` by the CUDA kernel ``csrc/scatter.cu``
    (``cms_rows_add``, its ids route): one launch hashes each id's columns in
    registers (``csrc/cm_hash.cuh``) and folds them into the table.

    On a CPU tensor this is the plain version. On a CUDA tensor the kernel is
    launched on the current stream or the call raises: on another device, a
    table that is not 2-D int32, more than ``CMS_MAX_DEPTH`` rows, non-integer
    or non-contiguous ids, N >= 2**31, or a launch error.
    """
    if _batched.is_batched(counts, ids):
        return _cms_ids_add_op(counts, ids)
    if counts.device.type == "cpu":
        return cms_ids_add_reference(counts, ids)
    what = "cms_ids_add_cuda"
    _check_table(what, counts, 2)
    depth, width = counts.shape
    if depth > CMS_MAX_DEPTH:
        raise ValueError(f"{what}: depth {depth} is above CMS_MAX_DEPTH = {CMS_MAX_DEPTH}")
    device = counts.device
    i = _flat_int32(what, "ids", ids, device)
    n = i.numel()
    if n > MAX_CUDA_SIZE:
        raise ValueError(f"{what}: N = {n} >= 2**31 is not supported")
    _require_cuda(what, device)
    out = counts.clone(memory_format=torch.contiguous_format)
    if n == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = _lib().cms_ids_add_launch(i.data_ptr(), n, depth, width, out.data_ptr(), stream)
    _raise_on(code, "cms_rows_add")
    _counted("cms_rows_add")
    return out


# --------------------------------------------------------------------- batched calls (custom ops)


@torch.library.custom_op("metrics_tpu_torch::hist_add", mutates_args=())
def _hist_add_op(bins: Tensor, idx: Tensor, weights: Tensor) -> Tensor:
    """:func:`hist_add_cuda` as a custom op: the route of a batched call."""
    return hist_add_cuda(bins, idx, weights)


@torch.library.custom_op("metrics_tpu_torch::hist_max", mutates_args=())
def _hist_max_op(bins: Tensor, idx: Tensor, values: Tensor) -> Tensor:
    """:func:`hist_max_cuda` as a custom op: the route of a batched call."""
    return hist_max_cuda(bins, idx, values)


@torch.library.custom_op("metrics_tpu_torch::cms_rows_add", mutates_args=())
def _cms_rows_add_op(counts: Tensor, cols: Tensor, valid: Tensor) -> Tensor:
    """:func:`cms_rows_add_cuda` as a custom op: the route of a batched call."""
    return cms_rows_add_cuda(counts, cols, valid)


@torch.library.custom_op("metrics_tpu_torch::cms_ids_add", mutates_args=())
def _cms_ids_add_op(counts: Tensor, ids: Tensor) -> Tensor:
    """:func:`cms_ids_add_cuda` as a custom op: the route of a batched call."""
    return cms_ids_add_cuda(counts, ids)


for _op, _wrapper in ((_hist_add_op, hist_add_cuda), (_hist_max_op, hist_max_cuda),
                      (_cms_rows_add_op, cms_rows_add_cuda), (_cms_ids_add_op, cms_ids_add_cuda)):
    _op.register_fake(lambda table, *rest: torch.empty_like(table, memory_format=torch.contiguous_format))
    _op.register_vmap(_batched.loop_rule(_wrapper))


# --------------------------------------------------------------------- registry


def _hist_eligible(bins: Tensor, idx: Tensor, values: Tensor) -> bool:
    return bins.dim() == 1 and bins.dtype == torch.int32 and 1 <= bins.numel() <= MAX_CUDA_SIZE and idx.numel() <= MAX_CUDA_SIZE


def _cms_eligible(counts: Tensor, cols: Tensor, valid: Tensor) -> bool:
    return (
        counts.dim() == 2
        and counts.dtype == torch.int32
        and cols.dim() == 2
        and 1 <= counts.numel() <= MAX_CUDA_SIZE
        and valid.numel() <= MAX_CUDA_SIZE
    )


registry.register(
    registry.KernelEntry(
        name="ddsketch_hist_add", reference=hist_add_reference, optimized=hist_add_cuda, eligible=_hist_eligible
    )
)
registry.register(
    registry.KernelEntry(
        name="hll_scatter_max", reference=hist_max_reference, optimized=hist_max_cuda, eligible=_hist_eligible
    )
)
registry.register(
    registry.KernelEntry(
        name="cms_row_scatter", reference=cms_rows_add_reference, optimized=cms_rows_add_cuda, eligible=_cms_eligible
    )
)
