"""SSIM and multi-scale SSIM (port of ``metrics_tpu/functional/image/ssim.py``).

The five sliding-window statistics (mu_p, mu_t, E[p^2], E[t^2], E[pt]) come
from ONE separable banded product over the 5B-stacked batch, as in the JAX
package; MS-SSIM pools by 2 between scales. The variances are differences
(E[x^2] - mu^2), which lose digits: the tests compare on absolute error.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.helper import (
    _as_image,
    _avg_pool,
    _depthwise_conv_separable,
    _gaussian,
    _reflection_pad,
)
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.distributed import reduce


def _ssim_check_inputs(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    preds = _as_image(preds)
    target = _as_image(target)
    if not preds.is_floating_point():
        preds = preds.to(torch.float32)
    if not target.is_floating_point():
        target = target.to(torch.float32)
    _check_same_shape(preds, target)
    if preds.ndim not in (4, 5):
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW or BxCxDxHxW shape. Got {preds.shape}.")
    return preds, target


def _ssim_update(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
):
    """Per-image SSIM."""
    is_3d = preds.ndim == 5
    n_sp = 3 if is_3d else 2

    if not isinstance(sigma, Sequence):
        sigma = n_sp * [sigma]
    if not isinstance(kernel_size, Sequence):
        kernel_size = n_sp * [kernel_size]
    if len(kernel_size) != n_sp or len(sigma) != n_sp:
        raise ValueError(
            f"`kernel_size` has dimension {len(kernel_size)} and `sigma` has dimension {len(sigma)},"
            f" but expected {n_sp} for {'3d' if is_3d else '2d'} inputs"
        )
    if return_full_image and return_contrast_sensitivity:
        raise ValueError("Arguments `return_full_image` and `return_contrast_sensitivity` are mutually exclusive.")
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    if data_range is None:
        data_range = torch.maximum(torch.max(preds) - torch.min(preds), torch.max(target) - torch.min(target))

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    dtype = preds.dtype

    if gaussian_kernel:
        size = [int(3.5 * s + 0.5) * 2 + 1 for s in sigma]
        factors = [_gaussian(k, s, dtype, preds.device).reshape(-1) for k, s in zip(size, sigma)]
    else:
        size = list(kernel_size)
        factors = [torch.ones(k, dtype=dtype, device=preds.device) / k for k in size]

    pads = [(s - 1) // 2 for s in size]
    preds_p = _reflection_pad(preds, pads)
    target_p = _reflection_pad(target, pads)

    # one banded product over the 5B-stacked batch: mu_p, mu_t, E[p^2], E[t^2], E[pt]
    input_list = torch.cat([preds_p, target_p, preds_p * preds_p, target_p * target_p, preds_p * target_p])
    outputs = _depthwise_conv_separable(input_list, factors)
    b = preds.shape[0]
    mu_pred, mu_target, e_pp, e_tt, e_pt = (outputs[i * b: (i + 1) * b] for i in range(5))

    mu_pred_sq = torch.square(mu_pred)
    mu_target_sq = torch.square(mu_target)
    mu_pred_target = mu_pred * mu_target

    sigma_pred_sq = e_pp - mu_pred_sq
    sigma_target_sq = e_tt - mu_target_sq
    sigma_pred_target = e_pt - mu_pred_target

    upper = 2 * sigma_pred_target.to(dtype) + c2
    lower = (sigma_pred_sq + sigma_target_sq).to(dtype) + c2

    ssim_idx_full_image = ((2 * mu_pred_target + c1) * upper) / ((mu_pred_sq + mu_target_sq + c1) * lower)

    # the product's output is the padded image's VALID region (the original
    # size); crop the border the padding reached
    sl = tuple(slice(p, d - p) for p, d in zip(pads, ssim_idx_full_image.shape[2:]))
    ssim_idx = ssim_idx_full_image[(Ellipsis, *sl)]

    if return_contrast_sensitivity:
        contrast_sensitivity = (upper / lower)[(Ellipsis, *sl)]
        return ssim_idx.reshape(b, -1).mean(-1), contrast_sensitivity.reshape(b, -1).mean(-1)
    if return_full_image:
        return ssim_idx.reshape(b, -1).mean(-1), ssim_idx_full_image
    return ssim_idx.reshape(b, -1).mean(-1)


def _ssim_compute(similarities: Tensor, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    return reduce(similarities, reduction)


def structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
):
    """SSIM of 2-D (BxCxHxW) or 3-D (BxCxDxHxW) images.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import structural_similarity_index_measure
        >>> gen = torch.Generator().manual_seed(0)
        >>> preds = torch.rand(2, 3, 32, 32, generator=gen)
        >>> target = preds * 0.75 + torch.rand(2, 3, 32, 32, generator=gen) * 0.25
        >>> round(float(structural_similarity_index_measure(preds, target, data_range=1.0)), 2)
        0.92
    """
    preds, target = _ssim_check_inputs(preds, target)
    out = _ssim_update(
        preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2,
        return_full_image, return_contrast_sensitivity,
    )
    if isinstance(out, tuple):
        return _ssim_compute(out[0], reduction), out[1]
    return _ssim_compute(out, reduction)


def _get_normalized_sim_and_cs(
    preds: Tensor, target: Tensor, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, normalize=None
) -> Tuple[Tensor, Tensor]:
    sim, cs = _ssim_update(
        preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, return_contrast_sensitivity=True
    )
    if normalize == "relu":
        sim = torch.clamp(sim, min=0.0)
        cs = torch.clamp(cs, min=0.0)
    return sim, cs


def _multiscale_ssim_update(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = None,
) -> Tensor:
    """MS-SSIM per image: the contrast sensitivity at every scale, the
    similarity at the last."""
    is_3d = preds.ndim == 5
    n_sp = 3 if is_3d else 2
    if not isinstance(kernel_size, Sequence):
        kernel_size = n_sp * [kernel_size]
    if not isinstance(sigma, Sequence):
        sigma = n_sp * [sigma]

    if preds.shape[-1] < 2 ** len(betas) or preds.shape[-2] < 2 ** len(betas):
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)}, the image height and width dimensions must be"
            f" larger than or equal to {2 ** len(betas)}."
        )
    _betas_div = max(1, (len(betas) - 1)) ** 2
    if preds.shape[-2] // _betas_div <= kernel_size[0] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[0]},"
            f" the image height must be larger than {(kernel_size[0] - 1) * _betas_div}."
        )
    if preds.shape[-1] // _betas_div <= kernel_size[1] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[1]},"
            f" the image width must be larger than {(kernel_size[1] - 1) * _betas_div}."
        )

    mcs_list: List[Tensor] = []
    sim = None
    for _ in range(len(betas)):
        sim, cs = _get_normalized_sim_and_cs(
            preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, normalize
        )
        mcs_list.append(cs)
        preds = _avg_pool(preds, 2)
        target = _avg_pool(target, 2)

    mcs_list[-1] = sim
    mcs_stack = torch.stack(mcs_list)
    if normalize == "simple":
        mcs_stack = (mcs_stack + 1) / 2
    betas_arr = torch.tensor(betas, dtype=mcs_stack.dtype, device=mcs_stack.device).reshape(-1, 1)
    return torch.prod(mcs_stack**betas_arr, dim=0)


def multiscale_structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = "relu",
) -> Tensor:
    """MS-SSIM.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import multiscale_structural_similarity_index_measure
        >>> gen = torch.Generator().manual_seed(0)
        >>> preds = torch.rand(2, 3, 192, 192, generator=gen)
        >>> target = preds * 0.75 + torch.rand(2, 3, 192, 192, generator=gen) * 0.25
        >>> round(float(multiscale_structural_similarity_index_measure(preds, target, data_range=1.0)), 2)
        0.94
    """
    if not isinstance(betas, tuple) or not all(isinstance(b, float) for b in betas):
        raise ValueError("Argument `betas` is expected to be of a type tuple of floats.")
    if normalize is not None and normalize not in ("relu", "simple"):
        raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")
    preds, target = _ssim_check_inputs(preds, target)
    mcs_per_image = _multiscale_ssim_update(
        preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, betas, normalize
    )
    return reduce(mcs_per_image, reduction)
