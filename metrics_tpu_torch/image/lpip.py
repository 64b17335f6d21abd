"""Learned Perceptual Image Patch Similarity (port of ``metrics_tpu/image/lpip.py``).

The default backend runs the port's LPIPS network
(:mod:`metrics_tpu_torch.image.lpips_net`) on the metric's device; a callable
``(img1, img2) -> (N,)`` may stand in for it, and ``backend="lpips"`` wraps
the ``lpips`` package where it is installed. The states are float32 sums.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.metric import Metric, zero_state
from metrics_tpu_torch.utils.imports import _LPIPS_AVAILABLE


class LearnedPerceptualImagePatchSimilarity(Metric):
    """Learned Perceptual Image Patch Similarity.

    Example (needs LPIPS weights on disk; not run):
        >>> import torch
        >>> from metrics_tpu_torch.image import LearnedPerceptualImagePatchSimilarity
        >>> metric = LearnedPerceptualImagePatchSimilarity(net_type="alex")  # doctest: +SKIP
        >>> img1 = torch.rand(2, 3, 64, 64, device="cuda") * 2 - 1  # doctest: +SKIP
        >>> img2 = torch.rand(2, 3, 64, 64, device="cuda") * 2 - 1  # doctest: +SKIP
        >>> metric.update(img1, img2)  # doctest: +SKIP
        >>> metric.compute()  # doctest: +SKIP
        tensor(0.3..., device='cuda:0')
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    sum_scores: Tensor
    total: Tensor

    def __init__(
        self,
        net_type: str = "alex",
        reduction: str = "mean",
        normalize: bool = False,
        distance_fn: Optional[Callable] = None,
        weights_path: Optional[str] = None,
        backend: str = "jax",
        allow_random_weights: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        valid_net_type = ("vgg", "alex", "squeeze")
        if net_type not in valid_net_type:
            raise ValueError(f"Argument `net_type` must be one of {valid_net_type}, but got {net_type}.")
        if backend not in ("jax", "lpips"):
            raise ValueError(f"Argument `backend` must be 'jax' or 'lpips', but got {backend}.")
        valid_reduction = ("mean", "sum")
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")
        if not isinstance(normalize, bool):
            raise ValueError(f"Argument `normalize` should be a bool but got {normalize}")
        if distance_fn is None:
            if backend == "lpips":
                if not _LPIPS_AVAILABLE:
                    raise ModuleNotFoundError(
                        "backend='lpips' requires the lpips package (`pip install lpips`);"
                        " the default backend='jax' (the port's own network) needs none."
                    )
                import lpips  # pragma: no cover

                net = lpips.LPIPS(net=net_type).to(self.device)  # pragma: no cover

                def distance_fn(a: Tensor, b: Tensor) -> Tensor:  # pragma: no cover
                    with torch.no_grad():
                        return net(a.to(torch.float32), b.to(torch.float32)).reshape(-1)
            else:
                from metrics_tpu_torch.image.lpips_net import make_distance_fn

                distance_fn = make_distance_fn(
                    net_type, weights_path=weights_path, allow_random_weights=allow_random_weights, device=self.device
                )
        self.distance_fn = distance_fn
        self.reduction = reduction
        self.normalize = normalize

        self.add_state("sum_scores", zero_state((), device=self.device), dist_reduce_fx="sum")
        self.add_state("total", zero_state((), device=self.device), dist_reduce_fx="sum")

    def update(self, img1: Tensor, img2: Tensor) -> None:
        img1 = torch.as_tensor(img1, device=self.device)
        img2 = torch.as_tensor(img2, device=self.device)
        if self.normalize:
            # [0, 1] -> [-1, 1], the nets' range
            img1 = 2 * img1 - 1
            img2 = 2 * img2 - 1
        loss = torch.as_tensor(self.distance_fn(img1, img2), device=self.device).reshape(-1).to(torch.float32)
        self.sum_scores = self.sum_scores + torch.sum(loss)
        self.total = self.total + loss.shape[0]

    def compute(self) -> Tensor:
        if self.reduction == "mean":
            return self.sum_scores / self.total
        return self.sum_scores
