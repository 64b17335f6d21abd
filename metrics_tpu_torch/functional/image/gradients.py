"""Image gradients by one-step finite differences (port of
``metrics_tpu/functional/image/gradients.py``): forward differences along H
and W with a zero last row and column."""

from __future__ import annotations

from typing import Tuple

import torch.nn.functional as F
from torch import Tensor


def _image_gradients_validate(img: Tensor) -> None:
    if not hasattr(img, "ndim"):
        raise TypeError(f"The `img` expects an array type but got {type(img)}")
    if img.ndim != 4:
        raise RuntimeError(f"The `img` expects a 4D tensor but got {img.ndim}D tensor")


def _compute_image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    dy = img[..., 1:, :] - img[..., :-1, :]
    dx = img[..., :, 1:] - img[..., :, :-1]
    return F.pad(dy, (0, 0, 0, 1)), F.pad(dx, (0, 1, 0, 0))


def image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-pixel image gradients ``(dy, dx)`` of an ``(N, C, H, W)`` image.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional.image import image_gradients
        >>> image = torch.arange(0, 1 * 1 * 5 * 5, dtype=torch.float32).reshape(1, 1, 5, 5)
        >>> dy, dx = image_gradients(image)
        >>> dy[0, 0, :2, :]
        tensor([[5., 5., 5., 5., 5.],
                [5., 5., 5., 5., 5.]])
    """
    _image_gradients_validate(img)
    return _compute_image_gradients(img)
