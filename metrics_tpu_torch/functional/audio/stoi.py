"""STOI and ESTOI (port of ``metrics_tpu/functional/audio/stoi.py``).

The default backend is the port's native implementation
(:mod:`._stoi_native`), on the inputs' device; ``backend="pystoi"`` wraps the
optional ``pystoi`` package on the host and raises ``ModuleNotFoundError``
without it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.functional.audio._stoi_native import native_stoi
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.imports import _PYSTOI_AVAILABLE


def short_time_objective_intelligibility(
    preds: Tensor,
    target: Tensor,
    fs: int,
    extended: bool = False,
    keep_same_device: bool = False,
    backend: str = "native",
) -> Tensor:
    """STOI score per sample.

    Args:
        preds: estimated signal ``(..., time)``
        target: reference signal ``(..., time)``
        fs: sampling frequency in Hz
        extended: use the extended STOI (ESTOI) variant
        keep_same_device: return the score on the inputs' device (the native
            backend always computes there; this flag moves the ``pystoi``
            backend's host scores)
        backend: ``"native"`` (default) or ``"pystoi"`` (the optional package,
            on the host; ``ModuleNotFoundError`` when it is not installed)

    Example:
        >>> import torch
        >>> gen = torch.Generator().manual_seed(0)
        >>> target = torch.randn(8000, generator=gen)
        >>> preds = target + 0.1 * torch.randn(8000, generator=gen)
        >>> bool(short_time_objective_intelligibility(preds, target, 8000) > 0.9)
        True
    """
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    if backend == "native":
        _check_same_shape(preds, target)
        return native_stoi(preds, target, fs, extended)
    if backend != "pystoi":
        raise ValueError(f"backend must be 'native' or 'pystoi', got {backend!r}")

    # the dependency gate comes before the argument checks, as in the JAX package
    if not _PYSTOI_AVAILABLE:
        raise ModuleNotFoundError(
            "STOI with backend='pystoi' requires that `pystoi` is installed. Either install as"
            " `pip install torchmetrics[audio]` or `pip install pystoi`, or use backend='native'."
        )

    import pystoi

    _check_same_shape(preds, target)
    preds_np = preds.detach().cpu().numpy().reshape(-1, preds.shape[-1])
    target_np = target.detach().cpu().numpy().reshape(-1, preds.shape[-1])
    stoi_val_np = np.array([pystoi.stoi(t, p, fs, extended) for t, p in zip(target_np, preds_np)])
    stoi_val = torch.from_numpy(stoi_val_np.astype(np.float32)).reshape(preds.shape[:-1])
    return stoi_val.to(preds.device) if keep_same_device else stoi_val
