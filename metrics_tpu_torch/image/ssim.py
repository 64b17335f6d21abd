"""SSIM and MS-SSIM module metrics (port of ``metrics_tpu/image/ssim.py``): a
float32 similarity sum for the mean and sum reductions, a list otherwise."""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.ssim import _multiscale_ssim_update, _ssim_check_inputs, _ssim_update
from metrics_tpu_torch.metric import Metric, zero_state
from metrics_tpu_torch.utils.data import dim_zero_cat


class StructuralSimilarityIndexMeasure(Metric):
    """Structural Similarity Index Measure.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.image import StructuralSimilarityIndexMeasure
        >>> gen = torch.Generator().manual_seed(0)
        >>> preds = torch.rand(2, 3, 16, 16, generator=gen)
        >>> target = preds * 0.75 + torch.rand(2, 3, 16, 16, generator=gen) * 0.25
        >>> metric = StructuralSimilarityIndexMeasure(data_range=1.0, device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 1)
        0.9
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        gaussian_kernel: bool = True,
        sigma: Union[float, Sequence[float]] = 1.5,
        kernel_size: Union[int, Sequence[int]] = 11,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[float] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        return_full_image: bool = False,
        return_contrast_sensitivity: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        valid_reduction = ("elementwise_mean", "sum", "none", None)
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")

        if reduction in ("elementwise_mean", "sum"):
            self.add_state("similarity", zero_state((), device=self.device), dist_reduce_fx="sum")
        else:
            self.add_state("similarity", [], dist_reduce_fx="cat")
        self.add_state("total", zero_state((), device=self.device), dist_reduce_fx="sum")

        if return_contrast_sensitivity or return_full_image:
            self.add_state("image_return", [], dist_reduce_fx="cat")

        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.return_full_image = return_full_image
        self.return_contrast_sensitivity = return_contrast_sensitivity

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _ssim_check_inputs(preds, target)
        similarity_pack = _ssim_update(
            preds, target, self.gaussian_kernel, self.sigma, self.kernel_size, self.data_range,
            self.k1, self.k2, self.return_full_image, self.return_contrast_sensitivity,
        )
        if isinstance(similarity_pack, tuple):
            similarity, image = similarity_pack
            self.image_return.append(image)
        else:
            similarity = similarity_pack

        if self.reduction in ("elementwise_mean", "sum"):
            self.similarity = self.similarity + torch.sum(similarity)
        else:
            self.similarity.append(similarity)
        self.total = self.total + preds.shape[0]

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        if self.reduction == "elementwise_mean":
            similarity = self.similarity / self.total
        elif self.reduction == "sum":
            similarity = self.similarity
        else:
            similarity = dim_zero_cat(self.similarity)

        if self.return_contrast_sensitivity or self.return_full_image:
            return similarity, dim_zero_cat(self.image_return)
        return similarity


class MultiScaleStructuralSimilarityIndexMeasure(Metric):
    """Multi-scale SSIM over a pyramid of 2x-downsampled scales.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MultiScaleStructuralSimilarityIndexMeasure
        >>> img = torch.rand(2, 3, 48, 48, generator=torch.Generator().manual_seed(0))
        >>> metric = MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, betas=(0.2, 0.3, 0.5), device="cpu")
        >>> metric.update(img, img)
        >>> metric.compute()
        tensor(1.)
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        gaussian_kernel: bool = True,
        kernel_size: Union[int, Sequence[int]] = 11,
        sigma: Union[float, Sequence[float]] = 1.5,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[float] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
        normalize: Optional[str] = "relu",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        valid_reduction = ("elementwise_mean", "sum", "none", None)
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")

        if reduction in ("elementwise_mean", "sum"):
            self.add_state("similarity", zero_state((), device=self.device), dist_reduce_fx="sum")
        else:
            self.add_state("similarity", [], dist_reduce_fx="cat")
        self.add_state("total", zero_state((), device=self.device), dist_reduce_fx="sum")

        if not (isinstance(kernel_size, (Sequence, int))):
            raise ValueError("Argument `kernel_size` expected to be an sequence or an int")
        if not isinstance(betas, tuple) or not all(isinstance(beta, float) for beta in betas):
            raise ValueError("Argument `betas` is expected to be of a type tuple of floats.")
        if normalize and normalize not in ("relu", "simple"):
            raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")

        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.betas = betas
        self.normalize = normalize

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _ssim_check_inputs(preds, target)
        similarity = _multiscale_ssim_update(
            preds, target, self.gaussian_kernel, self.sigma, self.kernel_size, self.data_range,
            self.k1, self.k2, self.betas, self.normalize,
        )
        if self.reduction in ("none", None):
            self.similarity.append(similarity)
        else:
            self.similarity = self.similarity + torch.sum(similarity)
        self.total = self.total + preds.shape[0]

    def compute(self) -> Tensor:
        if self.reduction == "elementwise_mean":
            return self.similarity / self.total
        if self.reduction == "sum":
            return self.similarity
        return dim_zero_cat(self.similarity)
