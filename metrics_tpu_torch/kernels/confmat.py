"""Pair counts: the (R, C) co-occurrence count behind confusion matrices and
stat-scores (port of ``metrics_tpu/kernels/confmat.py``).

``counts[r, c] = number of i with row[i] == r, col[i] == c and mask[i]``, as
int32. Pairs with a negative or out-of-range index on either side are dropped.

- ``pair_count_bincount``: the plain reference, one ``torch.bincount`` over
  flattened pair keys. Serves CPU tensors.
- ``pair_count_matmul``: the one-hot matmul formulation, in float32 (exact for
  N < 2**24). A second plain version, for the tests.
- ``pair_count_cuda``: the wrapper of the CUDA kernel ``csrc/pair_count.cu``,
  which replaces the Pallas ``_pair_count_kernel``. It takes every
  1 <= N < 2**31: int32 atomics are exact there and bounded by neither the
  TPU's VMEM rails (``MAX_FUSED_DIM``/``MAX_FUSED_CELLS``) nor its f32
  accumulator's 2**24.

``pair_count`` routes through the registry: the kernel for CUDA tensors, the
bincount reference for CPU tensors. Nothing catches a kernel failure.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.kernels import _build, registry
from metrics_tpu_torch.obs import instrument as _obs

KERNEL_NAME = "pair_count"
MAX_CUDA_SIZE = 2**31 - 1  # n and R*C are passed as, and indexed within, int32 range

# Launches of the CUDA kernel, counted by ``pair_count_cuda`` where it launches.
launches = 0

_INDEX_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)


def pair_count_bincount(
    row_idx: Tensor,
    col_idx: Tensor,
    num_rows: int,
    num_cols: int,
    row_mask: Optional[Tensor] = None,
) -> Tensor:
    """(num_rows, num_cols) int32 pair counts via one flat bincount.

    Ignored (masked) and out-of-range pairs go to an overflow bucket (index
    ``num_rows * num_cols``) that is trimmed after counting: ``torch.bincount``
    raises on negative values, so no invalid key may reach it.
    """
    r = row_idx.reshape(-1).to(torch.int32)
    c = col_idx.reshape(-1).to(torch.int32)
    valid = (r >= 0) & (r < num_rows) & (c >= 0) & (c < num_cols)
    if row_mask is not None:
        valid = valid & row_mask.reshape(-1).to(torch.bool)
    cells = num_rows * num_cols
    key = torch.where(valid, r.to(torch.int64) * num_cols + c, cells)
    bins = torch.bincount(key, minlength=cells + 1)[:cells]
    return bins.reshape(num_rows, num_cols).to(torch.int32)


def pair_count_matmul(
    row_idx: Tensor,
    col_idx: Tensor,
    num_rows: int,
    num_cols: int,
    row_mask: Optional[Tensor] = None,
) -> Tensor:
    """(num_rows, num_cols) int32 pair counts as ``one_hot(r).T @ one_hot(c)``.

    float32 operands and output: 0/1 products and integer sums are exact below
    2**24. (A bf16 output, as a torch bf16 matmul would give, rounds any count
    above 256.) Out-of-range indices give all-zero one-hots; masked pairs get
    an all-zero row one-hot.
    """
    r = row_idx.reshape(-1).to(torch.int64)
    c = col_idx.reshape(-1).to(torch.int64)
    oh_r = (r[:, None] == torch.arange(num_rows, device=r.device)).to(torch.float32)
    if row_mask is not None:
        oh_r = oh_r * row_mask.reshape(-1).to(torch.bool).to(torch.float32)[:, None]
    oh_c = (c[:, None] == torch.arange(num_cols, device=c.device)).to(torch.float32)
    return (oh_r.T @ oh_c).to(torch.int32)


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL_NAME)
    if not getattr(lib, "_argtypes_set", False):
        lib.pair_count_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.pair_count_launch.restype = ctypes.c_int
        lib.pair_count_uses_shared.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.pair_count_uses_shared.restype = ctypes.c_int
        lib.pair_count_error_string.argtypes = [ctypes.c_int]
        lib.pair_count_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _as_index(x: Tensor, what: str) -> Tensor:
    if x.dtype not in _INDEX_DTYPES:
        raise TypeError(f"pair_count_cuda: {what} must be an integer tensor, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"pair_count_cuda: {what} must be contiguous")
    return x.reshape(-1).to(torch.int32)


def uses_shared_branch(num_rows: int, num_cols: int) -> bool:
    """True when a (num_rows, num_cols) table takes the kernel's shared-memory
    branch on the current CUDA device (builds the kernel if needed)."""
    code = _lib().pair_count_uses_shared(num_rows, num_cols)
    if code < 0:
        raise RuntimeError(f"pair_count_uses_shared: CUDA error {-code}")
    return bool(code)


def pair_count_cuda(
    row_idx: Tensor,
    col_idx: Tensor,
    num_rows: int,
    num_cols: int,
    row_mask: Optional[Tensor] = None,
) -> Tensor:
    """Pair counts by the CUDA kernel ``csrc/pair_count.cu``.

    On a CPU tensor this is :func:`pair_count_bincount`. On a CUDA tensor the
    kernel is launched on the current stream (no synchronisation) or the call
    raises: on a wrong device, a non-integer index dtype, a non-contiguous
    input, mismatched lengths, N >= 2**31, or a launch error.
    """
    global launches
    if row_idx.device.type == "cpu":
        return pair_count_bincount(row_idx, col_idx, num_rows, num_cols, row_mask)
    if row_idx.device.type != "cuda":
        raise ValueError(f"pair_count_cuda: tensors must lie on a CUDA device or the CPU, got {row_idx.device}")
    device = row_idx.device
    for name, t in (("col_idx", col_idx), ("row_mask", row_mask)):
        if t is not None and t.device != device:
            raise ValueError(f"pair_count_cuda: {name} is on {t.device}, row_idx on {device}")
    if num_rows < 1 or num_cols < 1 or num_rows * num_cols > MAX_CUDA_SIZE:
        raise ValueError(f"pair_count_cuda: table ({num_rows}, {num_cols}) out of range")
    r = _as_index(row_idx, "row_idx")
    c = _as_index(col_idx, "col_idx")
    n = r.numel()
    if c.numel() != n:
        raise ValueError(f"pair_count_cuda: row_idx has {n} elements, col_idx {c.numel()}")
    if n > MAX_CUDA_SIZE:
        raise ValueError(f"pair_count_cuda: N = {n} >= 2**31 is not supported")
    m = None
    if row_mask is not None:
        if not row_mask.is_contiguous():
            raise ValueError("pair_count_cuda: row_mask must be contiguous")
        if row_mask.numel() != n:
            raise ValueError(f"pair_count_cuda: row_mask has {row_mask.numel()} elements, expected {n}")
        flat = row_mask.reshape(-1)
        m = flat.view(torch.uint8) if flat.dtype == torch.bool else (flat != 0).to(torch.uint8)
    out = torch.zeros((num_rows, num_cols), dtype=torch.int32, device=device)
    if n == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = _lib().pair_count_launch(
            r.data_ptr(), c.data_ptr(), None if m is None else m.data_ptr(), n,
            num_rows, num_cols, out.data_ptr(), stream,
        )
    if code != 0:
        msg = _lib().pair_count_error_string(code).decode()
        raise RuntimeError(f"pair_count CUDA kernel failed to launch: {msg} (error {code})")
    launches += 1
    _obs.record_kernel_launch(KERNEL_NAME)
    return out


def _cuda_eligible(row_idx, col_idx, num_rows, num_cols, row_mask=None) -> bool:
    return row_idx.numel() <= MAX_CUDA_SIZE and 0 < num_rows * num_cols <= MAX_CUDA_SIZE


registry.register(
    registry.KernelEntry(
        name="pair_count_cuda",
        reference=pair_count_bincount,
        optimized=pair_count_cuda,
        eligible=_cuda_eligible,
    )
)


def pair_count(
    row_idx: Tensor,
    col_idx: Tensor,
    num_rows: int,
    num_cols: int,
    row_mask: Optional[Tensor] = None,
) -> Tensor:
    """The production pair count: the CUDA kernel on CUDA tensors, the
    bincount reference on CPU tensors."""
    return registry.dispatch("pair_count_cuda", row_idx, col_idx, num_rows, num_cols, row_mask)
