"""SDR and SI-SDR (port of ``metrics_tpu/functional/audio/sdr.py``).

The BSS-eval distortion filter comes from FFT auto- and cross-correlations
(``torch.fft.rfft`` / ``irfft``) and a batched solve of the symmetric
Toeplitz system, all in float32 (the JAX package's dtype with x64 off, C.8).
The solve is ``torch.linalg.solve_ex`` without its error check: no host sync,
and a singular system (a silent target) gives NaN as ``jnp.linalg.solve``
does, where ``torch.linalg.solve`` would raise. The NaN then becomes the
clipped floor of the value.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _as_x32, _check_same_shape


def _audio_pair(preds: Any, target: Any) -> Tuple[Tensor, Tensor, float]:
    """``(preds, target, eps)`` as the JAX package sees them with x64 off
    (float64 as float32), the shapes checked; ``eps`` is the inputs' float
    epsilon, and integer inputs raise ``ValueError`` as ``jnp.finfo`` does."""
    preds, target = _as_x32(torch.as_tensor(preds)), _as_x32(torch.as_tensor(target))
    _check_same_shape(preds, target)
    if not preds.is_floating_point():
        raise ValueError(f"data type {preds.dtype} not inexact")
    return preds, target, torch.finfo(preds.dtype).eps


def _symmetric_toeplitz(vector: Tensor) -> Tensor:
    """Symmetric Toeplitz matrix from the first row, shape [..., L] -> [..., L, L]."""
    v_len = vector.shape[-1]
    idx = torch.arange(v_len, device=vector.device)
    return vector[..., torch.abs(idx[:, None] - idx[None, :])]


def _compute_autocorr_crosscorr(target: Tensor, preds: Tensor, corr_len: int) -> Tuple[Tensor, Tensor]:
    """FFT-based autocorrelation of ``target`` and its cross-correlation with ``preds``."""
    n_fft = 2 ** math.ceil(math.log2(preds.shape[-1] + target.shape[-1] - 1))

    t_fft = torch.fft.rfft(target, n=n_fft, dim=-1)
    r_0 = torch.fft.irfft(t_fft.real**2 + t_fft.imag**2, n=n_fft, dim=-1)[..., :corr_len]

    p_fft = torch.fft.rfft(preds, n=n_fft, dim=-1)
    b = torch.fft.irfft(torch.conj(t_fft) * p_fft, n=n_fft, dim=-1)[..., :corr_len]

    return r_0, b


def signal_distortion_ratio(
    preds: Tensor,
    target: Tensor,
    use_cg_iter: Optional[int] = None,
    filter_length: int = 512,
    zero_mean: bool = False,
    load_diag: Optional[float] = None,
) -> Tensor:
    """Signal-to-distortion ratio in dB per sample, float32.

    ``use_cg_iter`` is accepted for parity and ignored: the Toeplitz system is
    always solved directly.

    Example:
        >>> import torch
        >>> gen = torch.Generator().manual_seed(0)
        >>> target = torch.randn(400, generator=gen)
        >>> preds = target + 0.1 * torch.randn(400, generator=gen)
        >>> bool(signal_distortion_ratio(preds, target, filter_length=64) > 15)
        True
    """
    preds, target = _as_x32(torch.as_tensor(preds)), _as_x32(torch.as_tensor(target))
    _check_same_shape(preds, target)
    del use_cg_iter
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)

    if zero_mean:
        preds = preds - preds.mean(dim=-1, keepdim=True)
        target = target - target.mean(dim=-1, keepdim=True)

    # normalize along time-axis to unit norm
    target = target / torch.clamp(torch.linalg.vector_norm(target, dim=-1, keepdim=True), min=1e-6)
    preds = preds / torch.clamp(torch.linalg.vector_norm(preds, dim=-1, keepdim=True), min=1e-6)

    r_0, b = _compute_autocorr_crosscorr(target, preds, corr_len=filter_length)

    if load_diag is not None:
        r_0 = torch.cat([r_0[..., :1] + load_diag, r_0[..., 1:]], dim=-1)

    r = _symmetric_toeplitz(r_0)
    sol = torch.linalg.solve_ex(r, b[..., None], check_errors=False)[0][..., 0]

    coh = torch.einsum("...l,...l->...", b, sol)

    # a perfect reconstruction rounds coh to 1 and a silent target gives NaN:
    # clamp into (eps, 1 - eps), which caps the value at about ±69 dB
    eps = torch.finfo(torch.float32).eps
    coh = torch.clamp(torch.nan_to_num(coh, nan=0.0), eps, 1 - eps)
    ratio = coh / (1 - coh)
    return 10.0 * torch.log10(ratio)


def scale_invariant_signal_distortion_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """SI-SDR in dB per sample.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(scale_invariant_signal_distortion_ratio(preds, target)), 3)
        18.403
    """
    preds, target, eps = _audio_pair(preds, target)

    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)

    alpha = (torch.sum(preds * target, dim=-1, keepdim=True) + eps) / (torch.sum(target**2, dim=-1, keepdim=True) + eps)
    target_scaled = alpha * target
    noise = target_scaled - preds

    val = (torch.sum(target_scaled**2, dim=-1) + eps) / (torch.sum(noise**2, dim=-1) + eps)
    return 10 * torch.log10(val)
