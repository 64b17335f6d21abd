"""Shared image helpers: separable gaussian windows as banded matrix products
(port of ``metrics_tpu/functional/image/helper.py``), and the input handling
the image functionals share (``_as_image``, and ``_sum`` / ``_mean`` with the
dtypes of ``jnp.sum`` / ``jnp.mean``).

The JAX package applies each separable window as one banded product a spatial
dimension (``_depthwise_conv_separable``), outside any Pallas kernel; so does
the port, with ``torch.tensordot``. A float32 product on the card runs in full
float32 while ``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's
default, which ``chip_smoke.py`` sets); TF32 would keep about three digits.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import Tensor

from metrics_tpu_torch.utils.checks import _as_x32


def _as_image(x: Any) -> Tensor:
    """``x`` as the JAX package sees it with x64 off (float64 as float32,
    integers by their low 32 bits)."""
    return _as_x32(torch.as_tensor(x))


def _sum(x: Tensor, dim: Optional[Union[int, Sequence[int]]] = None) -> Tensor:
    """``jnp.sum``: the sum keeps ``x``'s dtype (torch sums integers as int64)."""
    dtype = None if x.is_floating_point() else x.dtype
    if dim is None:
        return torch.sum(x, dtype=dtype)
    return torch.sum(x, dim=dim, dtype=dtype)


def _mean(x: Tensor, dim: Optional[Union[int, Sequence[int]]] = None) -> Tensor:
    """``jnp.mean``: integers are averaged as float32."""
    x = x if x.is_floating_point() else x.to(torch.float32)
    return torch.mean(x) if dim is None else torch.mean(x, dim=dim)


def _gaussian(kernel_size: int, sigma: float, dtype: torch.dtype = torch.float32, device=None) -> Tensor:
    """1-D normalized gaussian window, shape ``(1, kernel_size)``."""
    dist = torch.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, 1.0, dtype=dtype, device=device)
    gauss = torch.exp(-torch.square(dist / sigma) / 2)
    return (gauss / torch.sum(gauss)).reshape(1, -1)


def _reflect_index(n: int, pad: int, device) -> Tensor:
    """Indices of a side of ``n`` reflected ``pad`` deep at both ends, again
    and again where ``pad >= n`` (numpy's and ``jnp.pad``'s "reflect")."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j >= n, period - j, j)


def _reflection_pad(x: Tensor, pads: Sequence[int]) -> Tensor:
    """Reflection-pad the trailing spatial dims (``pads`` per spatial dim), as
    ``jnp.pad(mode="reflect")``: ``F.pad`` where every pad is smaller than its
    side (it raises otherwise), else a gather that reflects again; an empty
    side raises the JAX package's ``ValueError``."""
    sizes = x.shape[2:]
    if any(n == 0 and p > 0 for n, p in zip(sizes, pads)):
        raise ValueError("Cannot apply 'reflect' padding to empty axis")
    if all(p < n for n, p in zip(sizes, pads)) and len(pads) in (2, 3):
        flat = [q for p in reversed(pads) for q in (p, p)]
        return F.pad(x, flat, mode="reflect")
    for axis, (n, p) in enumerate(zip(sizes, pads)):
        if p:
            x = x.index_select(2 + axis, _reflect_index(n, p, x.device))
    return x


def _avg_pool(x: Tensor, window: int = 2) -> Tensor:
    """Non-overlapping mean pool over the trailing spatial dims."""
    pool = F.avg_pool3d if x.ndim == 5 else F.avg_pool2d
    return pool(x, window)


def _band_matrix(f: Tensor, in_len: int, dtype: torch.dtype) -> Tensor:
    """(out_len, in_len) banded matrix whose row i holds window ``f`` at offset
    i: a VALID 1-D correlation as a dense product."""
    k = f.numel()
    out_len = in_len - k + 1
    rows = torch.arange(out_len, device=f.device)[:, None]
    cols = torch.arange(in_len, device=f.device)[None, :]
    offset = cols - rows  # the window position within each row
    band = torch.where((offset >= 0) & (offset < k), f[torch.clamp(offset, 0, k - 1)], 0)
    return band.to(dtype)


def _depthwise_conv_separable(x: Tensor, factors: Sequence[Tensor]) -> Tensor:
    """VALID depthwise convolution with a separable window: one banded product
    a spatial dimension."""
    for axis, f in enumerate(factors):
        sp_axis = 2 + axis
        band = _band_matrix(f.to(x.dtype), x.shape[sp_axis], x.dtype)
        x = torch.movedim(torch.tensordot(x, band, dims=([sp_axis], [1])), -1, sp_axis)
    return x
