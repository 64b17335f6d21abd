"""Threshold counts of the binned curve metrics (port of ``metrics_tpu/kernels/binned_curve.py``).

For scores ``p``, weighted targets ``tw`` and weights ``w`` (the curve updates
pass ``tw = y * w`` with a 0/1 mask ``w``) and thresholds ``thr``::

    tp[t] = sum_i w_i * tw_i         * [p_i >= thr_t]
    fp[t] = sum_i w_i * (w_i - tw_i) * [p_i >= thr_t]

in float32. The weight enters twice, as in the JAX package's kernel and
reference; for 0/1 weights that is the same as once. A NaN score passes no
threshold. With a column axis (``p``, ``tw`` of shape ``(M, C)``, ``w`` of
shape ``(M, C)`` or ``(M,)``) the same function holds per column and the
counts are ``(T, C)``: the multiclass and multilabel updates take it so, where
the JAX package builds a ``(T, M, C)`` comparison on accelerators.

- ``reference_counts``: the plain version, the comparison form
  ``((p >= thr) * w) @ tw`` in float32, cut into row chunks so that the
  comparison block stays small. Serves CPU tensors.
- ``sorted_route_counts``: the same function by the CUDA kernel's
  sorted-threshold route (sort the thresholds, bucket each score by a binary
  search, a per-column histogram, a suffix sum), in plain PyTorch: the CPU
  tests hold the route's semantics with it.
- ``binned_curve_counts_cuda``: the wrapper of the CUDA kernel
  ``csrc/binned_curve.cu``, which replaces the Pallas ``_kernel``. It takes
  the sorted-threshold route when a block's histograms and thresholds fit
  its shared memory (``uses_sorted_route``), else the comparison route, from
  the shapes alone.
- ``binned_curve_counts``: the registry entry ``binned_curve_counts``, under
  the JAX name: the kernel for CUDA tensors, the plain version for CPU ones.

Eligibility is every call the curve updates make: any ``M < 2**31`` (0
included: the wrapper then returns zeros and launches nothing), ``C <= 65535``
and ``T`` from 1 to ``65535 * 1024``. The JAX package's TPU rails
(``MAX_PALLAS_THRESHOLDS = 1024``, ``N >= 1``, ``N < 2**24``) are not carried
over. The kernel's sums run in a fixed order, so the same input gives the same
bits on every launch; with 0/1 weights the counts are integers, equal to the
plain version's bit for bit below 2**24 samples. Nothing catches a kernel
failure. Under ``torch.func.vmap`` the wrapper takes a batched call through
its custom op ``metrics_tpu_torch::binned_curve_counts``, whose rule calls the
wrapper once a copy (:mod:`._batched`).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.kernels import _batched, _build, _tally, registry
from metrics_tpu_torch.obs import instrument as _obs

KERNEL_NAME = "binned_curve"  # csrc/binned_curve.cu
MAX_CUDA_ROWS = 2**31 - 1
MAX_CUDA_COLS = 65535  # the grid's y dimension
MAX_CUDA_THRESHOLDS = 65535 * 1024  # the grid's z dimension times the thresholds of one block
_REFERENCE_BLOCK = 2**24  # elements of the plain version's comparison block per row chunk

# Launches of the CUDA kernel, counted by ``binned_curve_counts_cuda`` where it launches.
launches = 0


def _as_columns(preds: Tensor, target_w: Tensor, w: Tensor) -> Tuple[Tensor, Tensor, Tensor, bool]:
    """``(p, tw, w, one_column)``: 2-D ``(M, C)`` views, ``w`` broadcast over columns."""
    if preds.dim() not in (1, 2):
        raise ValueError(f"binned curve counts: preds must be (M,) or (M, C), got {tuple(preds.shape)}")
    if target_w.shape != preds.shape:
        raise ValueError(f"binned curve counts: target_w {tuple(target_w.shape)} and preds {tuple(preds.shape)} differ")
    one_column = preds.dim() == 1
    p = preds.reshape(-1, 1) if one_column else preds
    tw = target_w.reshape(p.shape)
    if w.shape == preds.shape:
        w2 = w.reshape(p.shape)
    elif not one_column and w.shape == preds.shape[:1]:
        w2 = w.reshape(-1, 1)
    else:
        raise ValueError(f"binned curve counts: w must be {tuple(preds.shape)} or per row, got {tuple(w.shape)}")
    return p, tw, w2, one_column


def reference_counts(preds: Tensor, target_w: Tensor, w: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor]:
    """``(tp, fp)``: float32 ``(T,)`` for 1-D ``preds``, ``(T, C)`` for ``(M, C)``."""
    p, tw, w2, one_column = _as_columns(preds, target_w, w)
    thr = thresholds.reshape(-1).to(device=p.device, dtype=torch.float32)
    m, n_cols = p.shape
    tp = torch.zeros((thr.shape[0], n_cols), dtype=torch.float32, device=p.device)
    fp = torch.zeros_like(tp)
    chunk = max(1, _REFERENCE_BLOCK // max(1, thr.shape[0]))
    for c in range(n_cols):
        pc = p[:, c].to(torch.float32)
        twc = tw[:, c].to(torch.float32)
        wc = w2[:, min(c, w2.shape[1] - 1)].to(torch.float32)
        for start in range(0, m, chunk):
            sl = slice(start, start + chunk)
            cmp = (pc[sl][None, :] >= thr[:, None]).to(torch.float32) * wc[sl][None, :]  # (T, rows)
            tp[:, c] += cmp @ twc[sl]
            fp[:, c] += cmp @ (wc[sl] - twc[sl])
    return (tp[:, 0], fp[:, 0]) if one_column else (tp, fp)


def _sort_thresholds(thr: Tensor) -> Tuple[Tensor, Tensor, int]:
    """``(sorted, rank, n_real)``: the thresholds in ascending order with NaN
    last and ties in the caller's order, each threshold's position in that
    order, and how many are not NaN."""
    order = torch.sort(thr, stable=True).indices  # NaN sorts last
    rank = torch.empty_like(order)
    rank[order] = torch.arange(thr.shape[0], device=thr.device)
    return thr[order], rank, int((~torch.isnan(thr)).sum())


def _bucket(p: Tensor, sorted_thr: Tensor, n_real: int) -> Tensor:
    """The number of sorted (not NaN) thresholds ``s`` with ``p >= s``, by a
    binary search that, like the kernel's bucket search, asks only ``p >= s``:
    a NaN score lands in bucket 0, and -0.0 / +0.0 and +-inf decide as in the
    comparison form."""
    b = torch.zeros(p.shape, dtype=torch.int64, device=p.device)
    step = 1 << max(n_real.bit_length() - 1, 0) if n_real else 0
    while step:
        cand = b + step
        probe = sorted_thr[(cand - 1).clamp(max=max(n_real - 1, 0))]
        b = torch.where((cand <= n_real) & (p >= probe), cand, b)
        step //= 2
    return b


def sorted_route_counts(preds: Tensor, target_w: Tensor, w: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor]:
    """:func:`reference_counts` by the kernel's sorted-threshold route, in plain PyTorch.

    Sort the thresholds (NaN last; a NaN threshold passes no score), put each
    sample in bucket ``b(p)`` (the number of sorted thresholds it passes),
    add ``w·tw`` and ``w·(w − tw)`` into a per-column histogram of ``T + 1``
    buckets, and give sorted threshold ``j`` the suffix sum of the buckets
    above ``j``, scattered back to the caller's order. With 0/1 weights every
    sum is an integer, so it equals :func:`reference_counts` bit for bit below
    2**24 samples. The CPU tests hold the route's semantics with it; no path
    calls it.
    """
    p, tw, w2, one_column = _as_columns(preds, target_w, w)
    thr = thresholds.reshape(-1).to(device=p.device, dtype=torch.float32)
    m, n_cols = p.shape
    n_thr = thr.shape[0]
    sorted_thr, rank, n_real = _sort_thresholds(thr)
    p, tw = p.to(torch.float32), tw.to(torch.float32)
    ww = w2.to(torch.float32).expand(m, n_cols)
    key = (_bucket(p, sorted_thr, n_real) + torch.arange(n_cols, device=p.device) * (n_thr + 1)).reshape(-1)
    tp, fp = [
        torch.zeros(n_cols * (n_thr + 1), dtype=torch.float32, device=p.device).index_add_(0, key, v.reshape(-1))
        .reshape(n_cols, n_thr + 1).flip(1).cumsum(1).flip(1)[:, 1:][:, rank].T
        for v in (ww * tw, ww * (ww - tw))
    ]
    return (tp[:, 0], fp[:, 0]) if one_column else (tp.contiguous(), fp.contiguous())


# --------------------------------------------------------------------- CUDA wrapper


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL_NAME)
    if not getattr(lib, "_argtypes_set", False):
        lib.binned_curve_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.binned_curve_launch.restype = ctypes.c_int
        lib.binned_curve_scratch_words.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        lib.binned_curve_scratch_words.restype = ctypes.c_longlong
        lib.binned_curve_uses_sorted.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.binned_curve_uses_sorted.restype = ctypes.c_int
        lib.binned_curve_error_string.argtypes = [ctypes.c_int]
        lib.binned_curve_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def uses_sorted_route(n_cols: int, n_thr: int) -> bool:
    """True when the kernel takes its sorted-threshold route for ``C`` columns and
    ``T`` thresholds on the CUDA device, False when it takes the comparison
    route (the kernel's own rule, ``binned_curve_uses_sorted``). Builds the
    kernels if needed."""
    return bool(_lib().binned_curve_uses_sorted(n_cols, n_thr))


def _check_input(name: str, x: Tensor, device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"binned_curve_counts_cuda: {name} is on {x.device}, preds on {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"binned_curve_counts_cuda: {name} must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"binned_curve_counts_cuda: {name} must be contiguous")


def binned_curve_counts_cuda(preds: Tensor, target_w: Tensor, w: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor]:
    """:func:`reference_counts` by the CUDA kernel ``csrc/binned_curve.cu``.

    On a CPU tensor this is the plain version. On a CUDA tensor the kernel is
    launched on the current stream (no synchronisation) or the call raises:
    on another device, inputs that are not contiguous float32 on one device,
    mismatched shapes, or sizes beyond the limits in the module docstring, or
    a launch error. ``M = 0`` returns zeros without a launch.
    """
    global launches
    if _batched.is_batched(preds, target_w, w, thresholds):
        return _binned_curve_op(preds, target_w, w, thresholds)
    if preds.device.type == "cpu":
        return reference_counts(preds, target_w, w, thresholds)
    p, tw, w2, one_column = _as_columns(preds, target_w, w)
    device = preds.device
    for name, x in (("preds", preds), ("target_w", target_w), ("w", w), ("thresholds", thresholds)):
        _check_input(name, x, device)
    if thresholds.dim() != 1 or not 1 <= thresholds.shape[0] <= MAX_CUDA_THRESHOLDS:
        raise ValueError(f"binned_curve_counts_cuda: thresholds must be (T,) with 1 <= T <= {MAX_CUDA_THRESHOLDS}")
    m, n_cols = p.shape
    n_thr = thresholds.shape[0]
    if m > MAX_CUDA_ROWS or not 1 <= n_cols <= MAX_CUDA_COLS:
        raise ValueError(f"binned_curve_counts_cuda: (M, C) = ({m}, {n_cols}) is out of range")
    if device.type != "cuda":  # checked after the shapes, so that the CPU tests reach every check on `meta` tensors
        raise ValueError(f"binned_curve_counts_cuda: tensors must lie on a CUDA device or the CPU, got {device}")
    if m == 0:
        tp = torch.zeros((n_thr, n_cols), dtype=torch.float32, device=device)
        return (tp[:, 0], tp[:, 0].clone()) if one_column else (tp, tp.clone())
    tp = torch.empty((n_thr, n_cols), dtype=torch.float32, device=device)  # the kernel writes every count
    fp = torch.empty_like(tp)
    lib = _lib()
    # Freed to the caching allocator on return: its next user on this stream runs after the kernel.
    scratch = torch.empty(lib.binned_curve_scratch_words(m, n_cols, n_thr), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.binned_curve_launch(
            p.data_ptr(), tw.data_ptr(), w2.data_ptr(), int(w.shape == preds.shape), thresholds.data_ptr(), m,
            n_cols, n_thr, scratch.data_ptr(), tp.data_ptr(), fp.data_ptr(), stream,
        )
    if code != 0:
        msg = lib.binned_curve_error_string(code).decode()
        raise _build.KernelLaunchError(f"binned_curve CUDA kernel failed to launch: {msg} (error {code})")
    launches += 1
    _tally.record(KERNEL_NAME)
    _obs.record_kernel_launch(KERNEL_NAME)
    return (tp[:, 0], fp[:, 0]) if one_column else (tp, fp)


@torch.library.custom_op("metrics_tpu_torch::binned_curve_counts", mutates_args=())
def _binned_curve_op(preds: Tensor, target_w: Tensor, w: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor]:
    """:func:`binned_curve_counts_cuda` as a custom op (fresh outputs): the
    route of a batched call."""
    return tuple(x.clone() for x in binned_curve_counts_cuda(preds, target_w, w, thresholds))


@_binned_curve_op.register_fake
def _(preds, target_w, w, thresholds):
    shape = (thresholds.shape[0],) + tuple(preds.shape[1:])
    return preds.new_empty(shape, dtype=torch.float32), preds.new_empty(shape, dtype=torch.float32)


_binned_curve_op.register_vmap(_batched.loop_rule(binned_curve_counts_cuda))


# --------------------------------------------------------------------- registry


def _eligible(preds: Tensor, target_w: Tensor, w: Tensor, thresholds: Tensor) -> bool:
    return (
        preds.dim() in (1, 2)
        and thresholds.dim() == 1
        and 1 <= thresholds.shape[0] <= MAX_CUDA_THRESHOLDS
        and preds.shape[0] <= MAX_CUDA_ROWS
        and (preds.dim() == 1 or 1 <= preds.shape[1] <= MAX_CUDA_COLS)
    )


registry.register(
    registry.KernelEntry(
        name="binned_curve_counts", reference=reference_counts, optimized=binned_curve_counts_cuda, eligible=_eligible
    )
)


def binned_curve_counts(preds: Tensor, target_w: Tensor, w: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor]:
    """``(tp, fp)`` of shape ``(T,)`` (or ``(T, C)``), registry-dispatched: the
    CUDA kernel for CUDA tensors, :func:`reference_counts` for CPU tensors.
    Strided inputs (a user's sliced thresholds or transposed scores) are made
    contiguous here, so that a call that works on the CPU works on the GPU."""
    args = (preds, target_w, w, thresholds)
    return registry.dispatch("binned_curve_counts", *(x.contiguous() for x in args))
