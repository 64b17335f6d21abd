"""Pair counts: the (R, C) co-occurrence count behind confusion matrices and
stat-scores (port of ``metrics_tpu/kernels/confmat.py``).

``counts[r, c] = number of i with row[i] == r, col[i] == c and mask[i]``, as
int32. A label counts by its low 32 bits (what the JAX package sees with x64
off). Pairs with a negative or out-of-range label on either side, or whose row
label equals ``ignore_index`` (compared after that truncation), are dropped.

- ``pair_count_bincount``: the plain reference, one ``torch.bincount`` over
  flattened pair keys. Serves CPU tensors.
- ``pair_count_matmul``: the one-hot matmul formulation, in float32 (exact for
  N < 2**24). A second plain version, for the tests.
- ``pair_count_cuda``: the table route of the CUDA kernel ``csrc/pair_count.cu``,
  which replaces the Pallas ``_pair_count_kernel``. It takes every
  1 <= N < 2**31: int32 atomics are exact there and bounded by neither the
  TPU's VMEM rails (``MAX_FUSED_DIM``/``MAX_FUSED_CELLS``) nor its f32
  accumulator's 2**24.
- ``stat_scores_bincount`` / ``stat_scores_cuda``: int32 tp, fp, tn, fn per
  class of the same pairs (what a multiclass stat-score update derives from
  the (C, C) table). The plain version builds the table and sums it; the
  kernel's stat-score route counts them without the table.

``pair_count`` and ``stat_scores`` route through the registry: the kernel for
CUDA tensors, the plain version for CPU tensors. Both kernel routes read int32
and int64 labels as they are. Nothing catches a kernel failure. Under
``torch.func.vmap`` both wrappers take a batched call through their custom op
(``metrics_tpu_torch::pair_count``, ``::stat_scores``), whose rule calls the
wrapper once a copy (:mod:`._batched`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.kernels import _batched, _build, _tally, registry
from metrics_tpu_torch.obs import instrument as _obs

KERNEL_NAME = "pair_count"
STAT_SCORES_NAME = "stat_scores"  # launches of the stat-score route, in the obs counters
MAX_CUDA_SIZE = 2**31 - 1  # n and R*C are passed as, and indexed within, int32 range
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1

# Launches of each route of the CUDA kernel, counted by its wrapper where it launches:
# the table route (``pair_count_cuda``) and the stat-score route (``stat_scores_cuda``).
launches = 0
stat_score_launches = 0

_INDEX_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)


def _check_ignore(ignore_index: Optional[int], caller: str) -> None:
    """An ``ignore_index`` is compared with int32 labels, so it must be an
    int32 itself (the JAX package raises an ``OverflowError`` on any other)."""
    if ignore_index is not None and not INT32_MIN <= ignore_index <= INT32_MAX:
        raise ValueError(f"{caller}: ignore_index = {ignore_index} lies outside the int32 range")


def _valid_pairs(r: Tensor, c: Tensor, num_rows: int, num_cols: int, row_mask: Optional[Tensor],
                 ignore_index: Optional[int]) -> Tensor:
    """Which pairs count, from int32 labels (the low 32 bits of the caller's):
    both in range, the row label not ``ignore_index``, and the mask set."""
    _check_ignore(ignore_index, "pair count")
    valid = (r >= 0) & (r < num_rows) & (c >= 0) & (c < num_cols)
    if ignore_index is not None:
        valid = valid & (r != ignore_index)
    if row_mask is not None:
        valid = valid & row_mask.reshape(-1).to(torch.bool)
    return valid


def pair_count_bincount(
    row_idx: Tensor,
    col_idx: Tensor,
    num_rows: int,
    num_cols: int,
    row_mask: Optional[Tensor] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """(num_rows, num_cols) int32 pair counts via one flat bincount.

    Ignored, masked and out-of-range pairs go to an overflow bucket (index
    ``num_rows * num_cols``) that is trimmed after counting: ``torch.bincount``
    raises on negative values, so no invalid key may reach it. Labels count by
    their low 32 bits, and ``ignore_index`` is compared after that truncation,
    as the JAX package compares it with x64 off.
    """
    r = row_idx.reshape(-1).to(torch.int32)
    c = col_idx.reshape(-1).to(torch.int32)
    valid = _valid_pairs(r, c, num_rows, num_cols, row_mask, ignore_index)
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
    ignore_index: Optional[int] = None,
) -> Tensor:
    """(num_rows, num_cols) int32 pair counts as ``one_hot(r).T @ one_hot(c)``.

    float32 operands and output: 0/1 products and integer sums are exact below
    2**24. (A bf16 output, as a torch bf16 matmul would give, rounds any count
    above 256.) Out-of-range indices give all-zero one-hots; masked and
    ignored pairs get an all-zero row one-hot.
    """
    r = row_idx.reshape(-1).to(torch.int32)
    c = col_idx.reshape(-1).to(torch.int32)
    valid = _valid_pairs(r, c, num_rows, num_cols, row_mask, ignore_index)
    oh_r = ((r[:, None] == torch.arange(num_rows, device=r.device)) & valid[:, None]).to(torch.float32)
    oh_c = (c[:, None] == torch.arange(num_cols, device=c.device)).to(torch.float32)
    return (oh_r.T @ oh_c).to(torch.int32)


def stat_scores_bincount(
    target: Tensor,
    preds: Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """int32 ``(C,)`` tp, fp, tn, fn of label pairs, from the (C, C) pair count
    as the JAX package derives them: ``tp = diag``, ``fn = row sums - tp``,
    ``fp = column sums - tp``, ``tn = total - tp - fn - fp``."""
    cm = pair_count_bincount(target, preds, num_classes, num_classes, ignore_index=ignore_index)
    tp = torch.diagonal(cm)
    fn = cm.sum(dim=1) - tp
    fp = cm.sum(dim=0) - tp
    tn = cm.sum() - tp - fn - fp
    return tp.to(torch.int32), fp.to(torch.int32), tn.to(torch.int32), fn.to(torch.int32)


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (argtypes, restype) of each C function of csrc/pair_count.cu, in its parameter order
_SIGNATURES = {
    "pair_count_launch": ([_P, _I, _P, _I, _P, _LL, _I, _I, _I, _I, _P, _P], _I),
    "stat_scores_launch": ([_P, _I, _P, _I, _LL, _I, _I, _I, _P, _P], _I),
    "pair_count_uses_shared": ([_I, _I], _I),
    "stat_scores_uses_shared": ([_I], _I),
    "pair_count_error_string": ([_I], ctypes.c_char_p),
}


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL_NAME)
    if not getattr(lib, "_argtypes_set", False):
        for name, (argtypes, restype) in _SIGNATURES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = restype
        lib._argtypes_set = True
    return lib


def _check_code(code: int, what: str) -> None:
    if code != 0:
        msg = _lib().pair_count_error_string(code).decode()
        raise _build.KernelLaunchError(f"{what} CUDA kernel failed to launch: {msg} (error {code})")


def _as_index(x: Tensor, what: str, caller: str) -> Tensor:
    """Flat labels the kernel reads as they are: int32 and int64 unchanged
    (contiguous), narrower integer types widened to int32."""
    if x.dtype not in _INDEX_DTYPES:
        raise TypeError(f"{caller}: {what} must be an integer tensor, got {x.dtype}")
    flat = x.reshape(-1).contiguous()
    return flat if flat.dtype in (torch.int32, torch.int64) else flat.to(torch.int32)


def _labels(row_idx: Tensor, col_idx: Tensor, caller: str) -> Tuple[Tensor, Tensor]:
    """The two label vectors of a CUDA call, checked: one CUDA device, equal
    lengths below 2**31."""
    if row_idx.device.type != "cuda":
        raise ValueError(f"{caller}: tensors must lie on a CUDA device or the CPU, got {row_idx.device}")
    if col_idx.device != row_idx.device:
        raise ValueError(f"{caller}: second labels are on {col_idx.device}, first on {row_idx.device}")
    r = _as_index(row_idx, "row_idx", caller)
    c = _as_index(col_idx, "col_idx", caller)
    if c.numel() != r.numel():
        raise ValueError(f"{caller}: row_idx has {r.numel()} elements, col_idx {c.numel()}")
    if r.numel() > MAX_CUDA_SIZE:
        raise ValueError(f"{caller}: N = {r.numel()} >= 2**31 is not supported")
    return r, c


def _ignore_args(ignore_index: Optional[int], caller: str) -> Tuple[int, int]:
    """``(ignore_index, has_ignore)`` for the C interface, which takes an int32."""
    _check_ignore(ignore_index, caller)
    return (0, 0) if ignore_index is None else (int(ignore_index), 1)


def uses_shared_branch(num_rows: int, num_cols: int) -> bool:
    """True when a (num_rows, num_cols) table takes the kernel's shared-memory
    branch on the current CUDA device (builds the kernel if needed)."""
    code = _lib().pair_count_uses_shared(num_rows, num_cols)
    if code < 0:
        raise RuntimeError(f"pair_count_uses_shared: CUDA error {-code}")
    return bool(code)


def stat_scores_uses_shared(num_classes: int) -> bool:
    """True when the stat-score kernel keeps its counters in shared memory for
    ``num_classes`` on the current CUDA device (builds the kernel if needed)."""
    code = _lib().stat_scores_uses_shared(num_classes)
    if code < 0:
        raise RuntimeError(f"stat_scores_uses_shared: CUDA error {-code}")
    return bool(code)


def pair_count_cuda(
    row_idx: Tensor,
    col_idx: Tensor,
    num_rows: int,
    num_cols: int,
    row_mask: Optional[Tensor] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Pair counts by the table route of the CUDA kernel ``csrc/pair_count.cu``.

    On a CPU tensor this is :func:`pair_count_bincount`. On a CUDA tensor the
    kernel is launched on the current stream (no synchronisation) or the call
    raises: on a wrong device, a non-integer label dtype, mismatched lengths,
    N >= 2**31, an ``ignore_index`` outside the int32 range, or a launch
    error. int32 and int64 labels are read as they are.
    """
    global launches
    if _batched.is_batched(row_idx, col_idx, row_mask):
        return _pair_count_op(row_idx, col_idx, num_rows, num_cols, row_mask, ignore_index)
    if row_idx.device.type == "cpu":
        return pair_count_bincount(row_idx, col_idx, num_rows, num_cols, row_mask, ignore_index)
    if num_rows < 1 or num_cols < 1 or num_rows * num_cols > MAX_CUDA_SIZE:
        raise ValueError(f"pair_count_cuda: table ({num_rows}, {num_cols}) out of range")
    r, c = _labels(row_idx, col_idx, "pair_count_cuda")
    n = r.numel()
    m = None
    if row_mask is not None:
        if row_mask.device != r.device:
            raise ValueError(f"pair_count_cuda: row_mask is on {row_mask.device}, row_idx on {r.device}")
        if row_mask.numel() != n:
            raise ValueError(f"pair_count_cuda: row_mask has {row_mask.numel()} elements, expected {n}")
        flat = row_mask.reshape(-1).contiguous()
        m = flat.view(torch.uint8) if flat.dtype == torch.bool else (flat != 0).to(torch.uint8)
    out = torch.zeros((num_rows, num_cols), dtype=torch.int32, device=r.device)
    if n == 0:
        return out
    ignore, has_ignore = _ignore_args(ignore_index, "pair_count_cuda")
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        code = _lib().pair_count_launch(
            r.data_ptr(), r.element_size() == 8, c.data_ptr(), c.element_size() == 8,
            None if m is None else m.data_ptr(), n, num_rows, num_cols, ignore, has_ignore, out.data_ptr(),
            stream,
        )
    _check_code(code, "pair_count")
    launches += 1
    _tally.record(KERNEL_NAME)
    _obs.record_kernel_launch(KERNEL_NAME)
    return out


def stat_scores_cuda(
    target: Tensor,
    preds: Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """int32 ``(C,)`` tp, fp, tn, fn by the stat-score route of the CUDA kernel
    ``csrc/pair_count.cu``, which never builds the (C, C) table.

    On a CPU tensor this is :func:`stat_scores_bincount`. On a CUDA tensor it is
    two device operations, zeroing one ``4 * C + 2`` int32 buffer and the
    kernel, on the current stream, or the call raises (as
    :func:`pair_count_cuda`). The four results are views of that buffer.
    """
    global stat_score_launches
    if _batched.is_batched(target, preds):
        return tuple(_stat_scores_op(target, preds, num_classes, ignore_index).unbind(0))
    if target.device.type == "cpu":
        return stat_scores_bincount(target, preds, num_classes, ignore_index)
    if num_classes < 1 or 4 * num_classes + 2 > MAX_CUDA_SIZE:
        raise ValueError(f"stat_scores_cuda: num_classes = {num_classes} out of range")
    t, p = _labels(target, preds, "stat_scores_cuda")
    n = t.numel()
    out = torch.zeros(4 * num_classes + 2, dtype=torch.int32, device=t.device)
    if n > 0:
        ignore, has_ignore = _ignore_args(ignore_index, "stat_scores_cuda")
        with torch.cuda.device(t.device):
            stream = torch.cuda.current_stream(t.device).cuda_stream
            code = _lib().stat_scores_launch(
                t.data_ptr(), t.element_size() == 8, p.data_ptr(), p.element_size() == 8, n, num_classes,
                ignore, has_ignore, out.data_ptr(), stream,
            )
        _check_code(code, "stat_scores")
        stat_score_launches += 1
        _tally.record("stat_scores")
        _obs.record_kernel_launch(STAT_SCORES_NAME)
    tp, fp, tn, fn = out[: 4 * num_classes].view(4, num_classes)
    return tp, fp, tn, fn


@torch.library.custom_op("metrics_tpu_torch::pair_count", mutates_args=())
def _pair_count_op(row_idx: Tensor, col_idx: Tensor, num_rows: int, num_cols: int, row_mask: Optional[Tensor],
                   ignore_index: Optional[int]) -> Tensor:
    """:func:`pair_count_cuda` as a custom op: the route of a batched call."""
    return pair_count_cuda(row_idx, col_idx, num_rows, num_cols, row_mask, ignore_index)


@_pair_count_op.register_fake
def _(row_idx, col_idx, num_rows, num_cols, row_mask, ignore_index):
    return row_idx.new_empty((num_rows, num_cols), dtype=torch.int32)


_pair_count_op.register_vmap(_batched.loop_rule(pair_count_cuda))


def _stacked_stat_scores(target: Tensor, preds: Tensor, num_classes: int, ignore_index: Optional[int]) -> Tensor:
    return torch.stack(stat_scores_cuda(target, preds, num_classes, ignore_index))


@torch.library.custom_op("metrics_tpu_torch::stat_scores", mutates_args=())
def _stat_scores_op(target: Tensor, preds: Tensor, num_classes: int, ignore_index: Optional[int]) -> Tensor:
    """:func:`stat_scores_cuda` as a custom op, its four results stacked into
    one ``(4, C)`` int32 tensor: the route of a batched call."""
    return _stacked_stat_scores(target, preds, num_classes, ignore_index)


@_stat_scores_op.register_fake
def _(target, preds, num_classes, ignore_index):
    return target.new_empty((4, num_classes), dtype=torch.int32)


_stat_scores_op.register_vmap(_batched.loop_rule(_stacked_stat_scores))


def _cuda_eligible(row_idx, col_idx, num_rows, num_cols, row_mask=None, ignore_index=None) -> bool:
    return row_idx.numel() <= MAX_CUDA_SIZE and 0 < num_rows * num_cols <= MAX_CUDA_SIZE


def _stat_scores_eligible(target, preds, num_classes, ignore_index=None) -> bool:
    return target.numel() <= MAX_CUDA_SIZE and 0 < 4 * num_classes + 2 <= MAX_CUDA_SIZE


registry.register(
    registry.KernelEntry(
        name="pair_count_cuda",
        reference=pair_count_bincount,
        optimized=pair_count_cuda,
        eligible=_cuda_eligible,
    )
)

registry.register(
    registry.KernelEntry(
        name="stat_scores_cuda",
        reference=stat_scores_bincount,
        optimized=stat_scores_cuda,
        eligible=_stat_scores_eligible,
    )
)


def pair_count(
    row_idx: Tensor,
    col_idx: Tensor,
    num_rows: int,
    num_cols: int,
    row_mask: Optional[Tensor] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """The production pair count: the CUDA kernel on CUDA tensors, the
    bincount reference on CPU tensors."""
    return registry.dispatch("pair_count_cuda", row_idx, col_idx, num_rows, num_cols, row_mask, ignore_index)


def stat_scores(
    target: Tensor,
    preds: Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The production stat scores of label pairs: the CUDA kernel's stat-score
    route on CUDA tensors, :func:`stat_scores_bincount` on CPU tensors."""
    return registry.dispatch("stat_scores_cuda", target, preds, num_classes, ignore_index)
