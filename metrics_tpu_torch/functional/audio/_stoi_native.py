"""Native STOI and ESTOI (port of ``metrics_tpu/functional/audio/_stoi_native.py``;
Taal et al. 2011, Jensen and Taal 2016).

The pipeline of the JAX package, batched over the pairs with fixed shapes:
polyphase resample to 10 kHz, Hann frames, silent-frame removal, a 512-point
rfft, 15 one-third-octave bands from 150 Hz, 30-frame segments and their
correlation. The constants and the host tables (the band matrix, the window,
the Octave-compatible resample filter and its phases) are built with numpy
exactly as the JAX package builds them.

- The resample is one ``F.conv1d`` with a phase filter an output channel and a
  gather of (phase, position) per output sample, in full float32
  (``utils.compute._float32_convolutions``).
- Silent frames (clean energy more than 40 dB below the loudest) are dropped
  by a stable sort of the keep mask, survivors first in their order, zeroed
  past the survivor count and overlap-added back; every segment carries a
  validity mask. A pair with fewer than 30 frames' worth of signal gives 1e-5,
  as pystoi does.
- float32 throughout with ``EPS = finfo(float32).eps``; ESTOI adds no dither.
"""

from __future__ import annotations

import fractions
import functools
import warnings
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from metrics_tpu_torch.utils.checks import _as_x32
from metrics_tpu_torch.utils.compute import _float32_convolutions

FS = 10_000  # internal sample rate (Hz)
N_FRAME = 256
HOP = N_FRAME // 2
NFFT = 512
NUMBAND = 15
MINFREQ = 150.0
N_SEG = 30  # frames per intermediate-intelligibility segment
BETA = -15.0  # lower SDR bound (dB)
DYN_RANGE = 40.0  # silent-frame dynamic range (dB)
EPS = float(np.finfo(np.float32).eps)
TOO_SHORT_VALUE = 1e-5  # pystoi's sentinel when fewer than N_SEG frames survive


@functools.lru_cache(maxsize=None)
def _third_octave_matrix() -> np.ndarray:
    """(NUMBAND, NFFT//2+1) 0/1 band matrix with edges snapped to rfft bins."""
    f = np.linspace(0, FS, NFFT + 1)[: NFFT // 2 + 1]
    k = np.arange(NUMBAND, dtype=np.float64)
    freq_low = MINFREQ * 2.0 ** ((2 * k - 1) / 6)
    freq_high = MINFREQ * 2.0 ** ((2 * k + 1) / 6)
    obm = np.zeros((NUMBAND, len(f)), np.float32)
    for i in range(NUMBAND):
        lo = int(np.argmin(np.square(f - freq_low[i])))
        hi = int(np.argmin(np.square(f - freq_high[i])))
        obm[i, lo:hi] = 1.0
    return obm


@functools.lru_cache(maxsize=None)
def _hann() -> np.ndarray:
    return np.hanning(N_FRAME + 2)[1:-1].astype(np.float32)


def _octave_resample_window(up: int, down: int) -> np.ndarray:
    """Octave-compatible anti-aliasing FIR: a Kaiser-by-formula lowpass (60 dB
    stopband rejection, cutoff ``1/(2·max(up, down))``, a roll-off a tenth of
    the cutoff), the resampler STOI's published values assume."""
    rejection_db = 60.0
    cutoff = 1.0 / (2.0 * max(up, down))
    roll_off_width = cutoff / 10.0
    half_len = int(np.ceil((rejection_db - 8.0) / (28.714 * roll_off_width)))
    t = np.arange(-half_len, half_len + 1)
    ideal = 2 * up * cutoff * np.sinc(2 * cutoff * t)
    beta = 0.1102 * (rejection_db - 8.7)
    return np.kaiser(2 * half_len + 1, beta) * ideal


@functools.lru_cache(maxsize=None)
def _resample_plan(fs: int) -> Tuple[np.ndarray, int, int, int, int]:
    """(flipped padded FIR, up, down, n_pre_remove, len_h) for fs -> 10 kHz:
    the window normalised to unit sum and scaled by ``up``, pre-padded as
    ``scipy.signal.resample_poly`` pads."""
    frac = fractions.Fraction(FS, int(fs))
    up, down = frac.numerator, frac.denominator
    h = _octave_resample_window(up, down).astype(np.float64)
    h = h / np.sum(h)
    half_len = (len(h) - 1) // 2
    h = h * up
    n_pre_pad = down - half_len % down
    n_pre_remove = (half_len + n_pre_pad) // down
    h = np.concatenate([np.zeros(n_pre_pad), h])
    return h[::-1].astype(np.float32).copy(), up, down, n_pre_remove, len(h)


@functools.lru_cache(maxsize=None)
def _phase_kernel(fs: int):
    """(phase kernel (up, 1, K), up, down, n_pre_remove, K): the polyphase
    decomposition of ``upfirdn(h, x, up, down)``. With ``y[j] = Σ_i x[i]·h[j·down
    − i·up]``, ``r = (j·down) mod up`` and ``s = (j·down) // up``, ``y[j] = (x ⊛
    h_r)[s]`` for the r-th phase ``h_r = h[r::up]``: all phases run as one conv
    with ``up`` output channels."""
    h, up, down, n_pre_remove, len_h = _resample_plan(fs)
    h = h[::-1]  # _resample_plan stores the flipped filter
    k = -(-len_h // up)
    phases = np.zeros((up, 1, k), np.float32)
    for r in range(up):
        taps = h[r::up]
        phases[r, 0, : len(taps)] = taps
    phases = phases[:, :, ::-1].copy()  # the conv correlates
    return phases, up, down, n_pre_remove, k


@functools.lru_cache(maxsize=16)
def _on_device(name: str, device: torch.device, fs: int = FS) -> Tensor:
    """A host table (``hann``, ``obm_t``, the ``phases`` of ``fs``) on ``device``, copied once."""
    if name == "phases":
        return torch.from_numpy(_phase_kernel(fs)[0]).to(device)
    return torch.from_numpy(_hann() if name == "hann" else np.ascontiguousarray(_third_octave_matrix().T)).to(device)


def _resample_to_10k(x: Tensor, fs: int) -> Tensor:
    """Polyphase resample (B, T) -> (B, ceil(T*up/down)), scipy-equivalent."""
    if fs == FS:
        return x
    n_in = x.shape[-1]
    _, up, down, n_pre_remove, k = _phase_kernel(fs)
    n_out = -(-n_in * up // down)
    j = torch.arange(n_pre_remove, n_pre_remove + n_out, device=x.device)
    with _float32_convolutions():
        # (B, up, n_in + k - 1): the full convolution of x with every phase filter
        out = F.conv1d(x[:, None, :], _on_device("phases", x.device, fs), padding=k - 1)
    needed = (n_pre_remove + n_out - 1) * down // up + 1
    if needed > out.shape[-1]:  # positions past the conv output are exact zeros
        out = F.pad(out, (0, needed - out.shape[-1]))
    return out[:, j * down % up, j * down // up]


def _frame(x: Tensor) -> Tensor:
    """(B, T) -> (B, M, N_FRAME) hop-128 frames; starts ``range(0, T - N_FRAME,
    HOP)``, an exclusive stop as in pystoi (a frame ending exactly at T is dropped)."""
    n_frames = max((x.shape[-1] - N_FRAME + HOP - 1) // HOP, 0)
    return x[..., torch.arange(n_frames, device=x.device)[:, None] * HOP + torch.arange(N_FRAME, device=x.device)]


def _overlap_add(frames: Tensor) -> Tensor:
    """(B, M, N_FRAME) hop-128 frames -> (B, (M+1)*HOP) signal."""
    b, m = frames.shape[0], frames.shape[1]
    halves = frames.reshape(b, m, 2, HOP)
    zero = frames.new_zeros(b, 1, HOP)
    return (torch.cat([halves[:, :, 0], zero], dim=1) + torch.cat([zero, halves[:, :, 1]], dim=1)).reshape(b, -1)


def _norm(z: Tensor, dim: int) -> Tensor:
    return torch.linalg.vector_norm(z, dim=dim, keepdim=True)


def _stoi_pairs(x: Tensor, y: Tensor, extended: bool) -> Tensor:
    """STOI of each (clean x, degraded y) row pair, both (B, T) at 10 kHz."""
    w = _on_device("hann", x.device)
    x_frames = _frame(x) * w
    y_frames = _frame(y) * w
    m = x_frames.shape[1]
    # the re-framed post-OLA signal yields m-1 spectral frames; a segment needs N_SEG
    if m - 1 < N_SEG:
        warnings.warn(
            "Not enough STFT segments to compute intermediate intelligibility measure; returning 1e-5",
            RuntimeWarning,
            stacklevel=4,
        )
        return torch.full((x.shape[0],), TOO_SHORT_VALUE, dtype=torch.float32, device=x.device)

    # silent-frame removal: a stable sort puts the survivors first, in their order
    energies = 20.0 * torch.log10(_norm(x_frames, -1)[..., 0] + EPS)
    keep = energies > (torch.amax(energies, dim=-1, keepdim=True) - DYN_RANGE)
    n_kept = torch.sum(keep, dim=-1, dtype=torch.int32)
    order = torch.argsort((~keep).to(torch.int32), dim=-1, stable=True)
    valid_frame = (torch.arange(m, device=x.device)[None, :] < n_kept[:, None]).to(torch.float32)[..., None]
    x_kept = torch.gather(x_frames, 1, order[..., None].expand_as(x_frames)) * valid_frame
    y_kept = torch.gather(y_frames, 1, order[..., None].expand_as(y_frames)) * valid_frame
    x_sil = _overlap_add(x_kept)
    y_sil = _overlap_add(y_kept)

    # 1/3-octave band spectrogram (frames past the survivors are masked per segment)
    obm_t = _on_device("obm_t", x.device)
    x_tob = torch.sqrt(torch.abs(torch.fft.rfft(_frame(x_sil) * w, n=NFFT)) ** 2 @ obm_t).transpose(1, 2)
    y_tob = torch.sqrt(torch.abs(torch.fft.rfft(_frame(y_sil) * w, n=NFFT)) ** 2 @ obm_t).transpose(1, 2)

    # N_SEG-frame segments; the OLA signal has n_kept-1 valid frames, so n_kept-N_SEG valid segments
    n_segments = x_tob.shape[-1] - N_SEG + 1
    seg_idx = torch.arange(n_segments, device=x.device)[:, None] + torch.arange(N_SEG, device=x.device)
    x_seg = x_tob[:, :, seg_idx]  # (B, NUMBAND, S, N_SEG)
    y_seg = y_tob[:, :, seg_idx]
    n_valid = torch.clamp(n_kept - N_SEG, min=0)
    valid_seg = (torch.arange(n_segments, device=x.device)[None, :] < n_valid[:, None]).to(torch.float32)
    valid_seg = valid_seg[:, None, :, None]

    if extended:

        def row_col_normalize(z: Tensor) -> Tensor:
            z = z - torch.mean(z, dim=-1, keepdim=True)
            z = z / (_norm(z, -1) + EPS)
            z = z - torch.mean(z, dim=1, keepdim=True)
            return z / (_norm(z, 1) + EPS)

        x_n = row_col_normalize(x_seg)
        y_n = row_col_normalize(y_seg)
        d = torch.sum(x_n * y_n * valid_seg, dim=(1, 2, 3)) / (N_SEG * torch.clamp(n_valid, min=1))
    else:
        norm_x = _norm(x_seg, -1)
        norm_y = _norm(y_seg, -1)
        clip_value = 10.0 ** (-BETA / 20.0)
        y_prime = torch.minimum(y_seg * norm_x / (norm_y + EPS), x_seg * (1.0 + clip_value))
        xc = x_seg - torch.mean(x_seg, dim=-1, keepdim=True)
        yc = y_prime - torch.mean(y_prime, dim=-1, keepdim=True)
        xc = xc / (_norm(xc, -1) + EPS)
        yc = yc / (_norm(yc, -1) + EPS)
        corr = torch.sum(xc * yc * valid_seg, dim=-1)  # (B, NUMBAND, S)
        d = torch.sum(corr, dim=(1, 2)) / (NUMBAND * torch.clamp(n_valid, min=1))

    return torch.where(n_valid > 0, d, torch.full_like(d, TOO_SHORT_VALUE)).to(torch.float32)


def native_stoi(preds: Tensor, target: Tensor, fs: int, extended: bool = False) -> Tensor:
    """Batched native STOI: ``preds`` and ``target`` ``(..., time)`` give
    ``preds.shape[:-1]`` (0-d for 1-D inputs), float32, on their device; the
    clean reference is ``target``."""
    if fs <= 0 or not float(fs).is_integer():
        raise ValueError(f"fs must be a positive integer sample rate, got {fs}")
    preds, target = _as_x32(torch.as_tensor(preds)), _as_x32(torch.as_tensor(target))
    lead = preds.shape[:-1]
    p = _resample_to_10k(preds.reshape(-1, preds.shape[-1]).to(torch.float32), int(fs))
    t = _resample_to_10k(target.reshape(-1, target.shape[-1]).to(torch.float32), int(fs))
    return _stoi_pairs(t, p, bool(extended)).reshape(lead)
