"""Spectral Angle Mapper (port of ``metrics_tpu/functional/image/sam.py``): the
angle between each pixel's channel vectors."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.helper import _as_image, _sum
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.distributed import reduce


def _sam_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    preds = _as_image(preds)
    target = _as_image(target)
    if preds.dtype != target.dtype:
        target = target.to(preds.dtype)
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {preds.shape}.")
    if preds.shape[1] <= 1:
        raise ValueError(
            "Expected channel dimension of `preds` and `target` to be larger than 1."
            f" Got preds: {preds.shape[1]}."
        )
    return preds, target


def _norm(x: Tensor) -> Tensor:
    """``jnp.linalg.norm`` over the channels (integers as float32)."""
    return torch.linalg.vector_norm(x if x.is_floating_point() else x.to(torch.float32), dim=1)


def _sam_compute(preds: Tensor, target: Tensor, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    dot_product = _sum(preds * target, dim=1)
    sam_score = torch.arccos(torch.clamp(dot_product / (_norm(preds) * _norm(target)), -1, 1))
    return reduce(sam_score, reduction)


def spectral_angle_mapper(preds: Tensor, target: Tensor, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    """Per-pixel spectral angle between channel vectors, reduced.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import spectral_angle_mapper
        >>> preds = torch.tensor([[[[1.0]], [[0.0]]]])
        >>> target = torch.tensor([[[[0.0]], [[1.0]]]])
        >>> round(float(spectral_angle_mapper(preds, target)), 4)
        1.5708
    """
    preds, target = _sam_update(preds, target)
    return _sam_compute(preds, target, reduction)
