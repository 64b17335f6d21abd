"""Kernel Inception Distance (port of ``metrics_tpu/image/kid.py``): list
states of features on the metric's device, and a polynomial-kernel MMD over
random subsets at compute.

The subsets are drawn on the host with ``np.random.permutation``, numpy's
global random state, as in the JAX package: a test seeded with
``np.random.seed`` draws the same subsets in both packages. The indices enter
as CPU tensors and select rows on the features' device.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.image.fid import _features, _images, _resolve_feature_extractor
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat


def maximum_mean_discrepancy(k_xx: Tensor, k_xy: Tensor, k_yy: Tensor) -> Tensor:
    """Unbiased MMD² estimate from kernel matrices."""
    m = k_xx.shape[0]
    kt_xx_sum = (torch.sum(k_xx) - torch.sum(torch.diag(k_xx))) / (m * (m - 1))
    kt_yy_sum = (torch.sum(k_yy) - torch.sum(torch.diag(k_yy))) / (m * (m - 1))
    k_xy_sum = torch.sum(k_xy) / (m * m)
    return kt_xx_sum + kt_yy_sum - 2 * k_xy_sum


def poly_kernel(f1: Tensor, f2: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0) -> Tensor:
    if gamma is None:
        gamma = 1.0 / f1.shape[1]
    return (f1 @ f2.T * gamma + coef) ** degree


def poly_mmd(f_real: Tensor, f_fake: Tensor, degree: int = 3, gamma: Optional[float] = None,
             coef: float = 1.0) -> Tensor:
    k_11 = poly_kernel(f_real, f_real, degree, gamma, coef)
    k_22 = poly_kernel(f_fake, f_fake, degree, gamma, coef)
    k_12 = poly_kernel(f_real, f_fake, degree, gamma, coef)
    return maximum_mean_discrepancy(k_11, k_12, k_22)


class KernelInceptionDistance(Metric):
    """Kernel Inception Distance.

    Example:
        >>> import numpy as np
        >>> import torch
        >>> from metrics_tpu_torch.image import KernelInceptionDistance
        >>> flatten8 = lambda imgs: imgs.reshape(imgs.shape[0], -1)[:, :8].float()
        >>> kid = KernelInceptionDistance(feature=flatten8, subsets=2, subset_size=4, device="cpu")
        >>> gen = torch.Generator().manual_seed(0)
        >>> kid.update(torch.rand(8, 3, 8, 8, generator=gen), real=True)
        >>> kid.update(torch.rand(8, 3, 8, 8, generator=gen), real=False)
        >>> np.random.seed(0)
        >>> kid_mean, kid_std = kid.compute()
        >>> bool(torch.isfinite(kid_mean))
        True
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    _host_compute = True  # random subsets drawn on the host at compute

    def __init__(
        self,
        feature: Union[int, Callable] = 2048,
        subsets: int = 100,
        subset_size: int = 1000,
        degree: int = 3,
        gamma: Optional[float] = None,
        coef: float = 1.0,
        reset_real_features: bool = True,
        normalize: bool = False,
        allow_random_weights: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.extractor, _ = _resolve_feature_extractor(feature, allow_random_weights, self.device)
        if not (isinstance(subsets, int) and subsets > 0):
            raise ValueError("Argument `subsets` expected to be integer larger than 0")
        self.subsets = subsets
        if not (isinstance(subset_size, int) and subset_size > 0):
            raise ValueError("Argument `subset_size` expected to be integer larger than 0")
        self.subset_size = subset_size
        if not (isinstance(degree, int) and degree > 0):
            raise ValueError("Argument `degree` expected to be integer larger than 0")
        self.degree = degree
        if gamma is not None and not (isinstance(gamma, float) and gamma > 0):
            raise ValueError("Argument `gamma` expected to be `None` or float larger than 0")
        self.gamma = gamma
        if not (isinstance(coef, float) and coef > 0):
            raise ValueError("Argument `coef` expected to be float larger than 0")
        self.coef = coef
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize

        self.add_state("real_features", [], dist_reduce_fx=None)
        self.add_state("fake_features", [], dist_reduce_fx=None)

    def update(self, imgs: Tensor, real: bool) -> None:
        features = _features(self.extractor, _images(imgs, self.normalize, self.device), self.device)
        (self.real_features if real else self.fake_features).append(features)

    def compute(self) -> Tuple[Tensor, Tensor]:
        real_features = dim_zero_cat(self.real_features)
        fake_features = dim_zero_cat(self.fake_features)

        n_samples_real = real_features.shape[0]
        if n_samples_real < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")
        n_samples_fake = fake_features.shape[0]
        if n_samples_fake < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")

        kid_scores_ = []
        for _ in range(self.subsets):
            perm = torch.from_numpy(np.random.permutation(n_samples_real)[: self.subset_size])
            f_real = real_features[perm.to(real_features.device)]
            perm = torch.from_numpy(np.random.permutation(n_samples_fake)[: self.subset_size])
            f_fake = fake_features[perm.to(fake_features.device)]
            kid_scores_.append(poly_mmd(f_real, f_fake, self.degree, self.gamma, self.coef))
        kid_scores = torch.stack(kid_scores_)
        return torch.mean(kid_scores), torch.std(kid_scores, correction=0)

    def reset(self) -> None:
        if not self.reset_real_features:
            value = self.real_features
            super().reset()
            self.real_features = value
        else:
            super().reset()
