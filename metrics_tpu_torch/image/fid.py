"""Fréchet Inception Distance (port of ``metrics_tpu/image/fid.py``).

``feature`` is an int tap (64 / 192 / 768 / 2048) or a logit head of the
port's InceptionV3 (``image/inception_net.py``), or any callable
``imgs -> (N, d)``. The states are running float32 sums and covariance sums of
features centred on the first batch's mean (a constant shift leaves the
covariance and the mean difference unchanged but removes the cancellation of
raw second moments in float32), and int32 counts: the JAX package's dtypes
with x64 off.

The matrix square root has two backends: ``"scipy"`` (on the host in
float64, exact; ``_host_compute`` is then True) and ``"newton"`` (Newton-Schulz
iterations of ``torch.matmul`` on the states' device, full float32 while
``torch.backends.cuda.matmul.allow_tf32`` is False, PyTorch's default).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.metric import Metric, zero_state
from metrics_tpu_torch.utils.device import DeviceLike
from metrics_tpu_torch.utils.imports import _SCIPY_AVAILABLE
from metrics_tpu_torch.utils.prints import rank_zero_info


def sqrtm_newton_schulz(mat: Tensor, num_iters: int = 100) -> Tensor:
    """Matrix square root by Newton-Schulz iteration, matrix products only.

    Converges for matrices with ||A/||A||_F - I|| < 1 (PSD covariance products
    in practice); about 1e-4 relative in float32, enough for FID's trace.
    """
    dim = mat.shape[0]
    norm = torch.linalg.norm(mat)
    y = mat / norm
    eye = torch.eye(dim, dtype=mat.dtype, device=mat.device)
    z = eye
    for _ in range(num_iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y = y @ t
        z = t @ z
    return y * torch.sqrt(norm)


def _sqrtm_scipy(mat: Tensor) -> Tensor:
    """The square root on the host in float64 (scipy), its real part back on
    ``mat``'s device in float32, as the JAX package's x64-off array."""
    import scipy.linalg

    res = scipy.linalg.sqrtm(mat.detach().cpu().numpy().astype(np.float64))
    return torch.from_numpy(np.array(res.real, dtype=np.float32)).to(mat.device)


def _compute_fid(mu1: Tensor, sigma1: Tensor, mu2: Tensor, sigma2: Tensor, eps: float = 1e-6,
                 sqrtm_backend: str = "scipy") -> Tensor:
    """d² = |μ1-μ2|² + Tr(Σ1 + Σ2 - 2·sqrt(Σ1·Σ2))."""
    sqrtm = _sqrtm_scipy if sqrtm_backend == "scipy" else sqrtm_newton_schulz
    diff = mu1 - mu2
    if sqrtm_backend == "newton":
        # Newton-Schulz oscillates on singular products (fewer samples than feature
        # dims); regularising unconditionally shifts the trace by O(d·√eps) at most
        offset = torch.eye(sigma1.shape[0], dtype=mu1.dtype, device=mu1.device) * eps
        sigma1 = sigma1 + offset
        sigma2 = sigma2 + offset
    covmean = sqrtm(sigma1 @ sigma2)
    if sqrtm_backend == "scipy" and not bool(torch.all(torch.isfinite(covmean))):
        rank_zero_info(f"FID calculation produces singular product; adding {eps} to diagonal of covariance estimates")
        offset = torch.eye(sigma1.shape[0], dtype=mu1.dtype, device=mu1.device) * eps
        covmean = sqrtm((sigma1 + offset) @ (sigma2 + offset))
    tr_covmean = torch.trace(covmean)
    return diff @ diff + torch.trace(sigma1) + torch.trace(sigma2) - 2 * tr_covmean


def _resolve_feature_extractor(feature: Union[int, str, Callable], allow_random_weights: bool = False,
                               device: DeviceLike = None) -> tuple:
    """``(extract_fn, num_features)``: an int or str ``feature`` builds the
    port's InceptionV3 on ``device`` (weights from
    ``$METRICS_TPU_INCEPTION_WEIGHTS``, or seeded random weights with
    ``allow_random_weights=True``); a callable is used as it is
    (``num_features`` None) and must return an ``(N, d)`` feature matrix."""
    if isinstance(feature, (int, str)) and not isinstance(feature, bool):
        from metrics_tpu_torch.image.inception_net import FEATURE_DIMS, InceptionFeatureExtractor

        if feature not in FEATURE_DIMS:
            valid_int_input = tuple(k for k in FEATURE_DIMS if isinstance(k, int))
            valid_str_input = tuple(k for k in FEATURE_DIMS if isinstance(k, str))
            raise ValueError(
                f"Input to argument `feature` must be one of {valid_int_input} (feature taps)"
                f" or {valid_str_input} (logit heads), but got {feature!r}."
            )
        extractor = InceptionFeatureExtractor(feature, allow_random_weights=allow_random_weights, device=device)
        return extractor, extractor.num_features
    if callable(feature):
        return feature, None
    raise TypeError("Got unknown input to argument `feature`: expected an int, a str or a callable")


def _images(imgs: Any, normalize: bool, device: torch.device) -> Tensor:
    """``imgs`` on ``device``; with ``normalize``, [0, 1] floats as uint8 (x 255)."""
    imgs = torch.as_tensor(imgs, device=device)
    return (imgs * 255).to(torch.uint8) if normalize else imgs


def _features(extractor: Callable, imgs: Tensor, device: torch.device) -> Tensor:
    return torch.as_tensor(extractor(imgs)).to(device)


class FrechetInceptionDistance(Metric):
    """Frechet Inception Distance.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.image import FrechetInceptionDistance
        >>> flatten8 = lambda imgs: imgs.reshape(imgs.shape[0], -1)[:, :8].float()
        >>> fid = FrechetInceptionDistance(feature=flatten8, num_features=8, device="cpu")
        >>> gen = torch.Generator().manual_seed(0)
        >>> fid.update(torch.rand(8, 3, 8, 8, generator=gen), real=True)
        >>> fid.update(torch.rand(8, 3, 8, 8, generator=gen), real=False)
        >>> bool(torch.isfinite(fid.compute()))
        True
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    real_features_sum: Tensor
    real_features_cov_sum: Tensor
    real_features_num_samples: Tensor
    fake_features_sum: Tensor
    fake_features_cov_sum: Tensor
    fake_features_num_samples: Tensor

    def __init__(
        self,
        feature: Union[int, Callable] = 2048,
        reset_real_features: bool = True,
        normalize: bool = False,
        num_features: Optional[int] = None,
        sqrtm_backend: str = "scipy",
        allow_random_weights: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.extractor, inferred = _resolve_feature_extractor(feature, allow_random_weights, self.device)
        num_features = num_features or inferred or (feature if isinstance(feature, int) else None)
        if num_features is None:
            raise ValueError(
                "When `feature` is a callable, pass `num_features=<d>` (its output feature dimension)."
            )
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        if sqrtm_backend not in ("scipy", "newton"):
            raise ValueError(f"Argument `sqrtm_backend` must be 'scipy' or 'newton', got {sqrtm_backend}")
        if sqrtm_backend == "scipy" and not _SCIPY_AVAILABLE:
            sqrtm_backend = "newton"
        self.reset_real_features = reset_real_features
        self.normalize = normalize
        self.sqrtm_backend = sqrtm_backend
        self._host_compute = sqrtm_backend == "scipy"
        d = num_features
        self.num_features = d

        dev = self.device
        for side in ("real", "fake"):
            self.add_state(f"{side}_features_sum", zero_state(d, device=dev), dist_reduce_fx="sum")
            self.add_state(f"{side}_features_cov_sum", zero_state((d, d), device=dev), dist_reduce_fx="sum")
            self.add_state(f"{side}_features_num_samples", zero_state((), torch.int32, dev), dist_reduce_fx="sum")
        # the first batch's mean, by which later features are centred
        self.add_state("real_center", zero_state(d, device=dev), dist_reduce_fx="mean")
        self.add_state("fake_center", zero_state(d, device=dev), dist_reduce_fx="mean")

    def _extract(self, imgs: Any) -> Tensor:
        features = _features(self.extractor, _images(imgs, self.normalize, self.device), self.device)
        if features.ndim == 1:
            features = features.reshape(1, -1)
        return features.to(self.real_features_sum.dtype)

    def update(self, imgs: Tensor, real: bool) -> None:
        features = self._extract(imgs)
        side = "real" if real else "fake"
        count = getattr(self, f"{side}_features_num_samples")
        center = torch.where(count == 0, features.mean(dim=0), getattr(self, f"{side}_center"))
        centered = features - center
        setattr(self, f"{side}_center", center)
        setattr(self, f"{side}_features_sum", getattr(self, f"{side}_features_sum") + centered.sum(dim=0))
        setattr(self, f"{side}_features_cov_sum", getattr(self, f"{side}_features_cov_sum") + centered.T @ centered)
        setattr(self, f"{side}_features_num_samples", count + features.shape[0])

    def compute(self) -> Tensor:
        n_real = self.real_features_num_samples
        n_fake = self.fake_features_num_samples
        mean_real_c = self.real_features_sum / n_real
        mean_fake_c = self.fake_features_sum / n_fake
        cov_real = (self.real_features_cov_sum - n_real * torch.outer(mean_real_c, mean_real_c)) / (n_real - 1)
        cov_fake = (self.fake_features_cov_sum - n_fake * torch.outer(mean_fake_c, mean_fake_c)) / (n_fake - 1)
        mean_real = mean_real_c + self.real_center
        mean_fake = mean_fake_c + self.fake_center
        return _compute_fid(mean_real, cov_real, mean_fake, cov_fake, sqrtm_backend=self.sqrtm_backend)

    def reset(self) -> None:
        """Keep the real distribution's states across resets if asked."""
        if not self.reset_real_features:
            kept = {name: getattr(self, name) for name in ("real_features_sum", "real_features_cov_sum",
                                                           "real_features_num_samples", "real_center")}
            super().reset()
            for name, value in kept.items():
                setattr(self, name, value)
        else:
            super().reset()
