"""Inception Score (port of ``metrics_tpu/image/inception.py``): a list state
of logits on the metric's device, and the split KL at compute.

The rows are shuffled on the host with ``np.random.permutation``, numpy's
global random state, as in the JAX package; the indices enter as a CPU
tensor. The splits are ``torch.tensor_split`` (``jnp.array_split``'s sizes),
the spread their standard deviation with ddof 1.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.image.fid import _features, _images, _resolve_feature_extractor
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat


class InceptionScore(Metric):
    """Inception Score.

    Example:
        >>> import numpy as np
        >>> import torch
        >>> from metrics_tpu_torch.image import InceptionScore
        >>> logits16 = lambda imgs: imgs.reshape(imgs.shape[0], -1)[:, :16].float()
        >>> metric = InceptionScore(feature=logits16, splits=2, device="cpu")
        >>> metric.update(torch.rand(8, 3, 8, 8, generator=torch.Generator().manual_seed(0)))
        >>> np.random.seed(0)
        >>> score_mean, score_std = metric.compute()
        >>> bool(score_mean > 0)
        True
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    _host_compute = True  # a host permutation and chunking at compute

    def __init__(
        self,
        feature: Union[int, Callable] = "logits_unbiased",
        splits: int = 10,
        normalize: bool = False,
        allow_random_weights: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if isinstance(feature, str) and feature not in ("logits", "logits_unbiased"):
            raise ValueError(
                f"Input to argument `feature` must be 'logits'/'logits_unbiased', an int or a callable, got {feature}"
            )
        self.extractor, _ = _resolve_feature_extractor(feature, allow_random_weights, self.device)
        if not (isinstance(splits, int) and splits > 0):
            raise ValueError("Argument `splits` expected to be integer larger than 0")
        self.splits = splits
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize
        self.add_state("features", [], dist_reduce_fx=None)

    def update(self, imgs: Tensor) -> None:
        self.features.append(_features(self.extractor, _images(imgs, self.normalize, self.device), self.device))

    def compute(self) -> Tuple[Tensor, Tensor]:
        features = dim_zero_cat(self.features)
        idx = torch.from_numpy(np.random.permutation(features.shape[0]))
        features = features[idx.to(features.device)]

        prob = torch.softmax(features, dim=1)
        log_prob = torch.log_softmax(features, dim=1)

        prob_chunks = torch.tensor_split(prob, self.splits, dim=0)
        log_prob_chunks = torch.tensor_split(log_prob, self.splits, dim=0)

        mean_prob = [torch.mean(p, dim=0, keepdim=True) for p in prob_chunks]
        kl_ = [p * (log_p - torch.log(m_p)) for p, log_p, m_p in zip(prob_chunks, log_prob_chunks, mean_prob)]
        kl = torch.stack([torch.exp(torch.mean(torch.sum(k, dim=1))) for k in kl_])
        return torch.mean(kl), torch.std(kl, correction=1)
