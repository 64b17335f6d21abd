"""Total variation (port of ``metrics_tpu/functional/image/tv.py``):
anisotropic, the absolute differences along H and W."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.helper import _as_image, _sum


def _total_variation_update(img: Tensor) -> Tuple[Tensor, int]:
    if img.ndim != 4:
        raise RuntimeError(f"Expected input `img` to be an 4D tensor, but got {img.shape}")
    diff1 = img[..., 1:, :] - img[..., :-1, :]
    diff2 = img[..., :, 1:] - img[..., :, :-1]
    score = _sum(torch.abs(diff1), dim=(1, 2, 3)) + _sum(torch.abs(diff2), dim=(1, 2, 3))
    return score, img.shape[0]


def _total_variation_compute(score: Tensor, num_elements, reduction: Optional[str]) -> Tensor:
    if reduction == "mean":
        return _sum(score) / num_elements
    if reduction == "sum":
        return _sum(score)
    if reduction is None or reduction == "none":
        return score
    raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")


def total_variation(img: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    """Anisotropic total variation.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import total_variation
        >>> total_variation(torch.tensor([[[[0.1, 0.2], [0.3, 0.4]]]]))
        tensor(0.6000)
    """
    score, num_elements = _total_variation_update(_as_image(img))
    return _total_variation_compute(score, num_elements, reduction)
