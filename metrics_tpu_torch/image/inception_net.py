"""InceptionV3 feature extractor for FID, KID and the Inception Score (port of
``metrics_tpu/image/inception_net.py``).

The FID variant of InceptionV3 (the TF-slim network behind the published FID
numbers) as an ``nn.Module`` in NCHW, layer for layer the JAX package's flax
net: BasicConv2d units (a conv without bias, frozen BatchNorm with eps 1e-3,
ReLU), the Inception A/B/C/D/E towers with the per-axis paddings of the
(1, 7), (7, 1), (1, 3) and (3, 1) factorisations, average pools that divide
by the valid elements under the window (``count_include_pad=False``), the
max-pool branch of the last E block, and a 1008-way fc. Feature taps at 64
(pool1), 192 (pool2), 768 (Mixed_6e) and 2048 (the final pool) are averaged
over space to ``(N, C)``; ``logits`` is the fc, ``logits_unbiased`` its
weight alone. Parameter names are torchvision's, so
``utils.params_io.inception_params_from_jax`` maps a JAX weights file onto
``state_dict`` keys one for one.

Weights: ``weights_path``, then ``$METRICS_TPU_INCEPTION_WEIGHTS`` (a flat
``.npz`` in the JAX package's format), else ``FileNotFoundError`` unless
``allow_random_weights=True`` opts into the port's own seeded random
initialisation: a CPU ``torch.Generator``, so the CPU and the card hold the
same weights. Random weights are self-consistent but not comparable to
published numbers.

The convolutions run in full float32 (``utils.compute._float32_convolutions``).
Images are resized to 299 x 299 by bilinear interpolation with antialiasing,
as ``jax.image.resize`` does: it antialiases when it downsamples.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from metrics_tpu_torch.utils.compute import _float32_convolutions
from metrics_tpu_torch.utils.device import DeviceLike, resolve_device
from metrics_tpu_torch.utils.params_io import inception_params_from_jax, load_params, save_params  # noqa: F401
from metrics_tpu_torch.utils.prints import rank_zero_warn

FEATURE_DIMS = {64: 64, 192: 192, 768: 768, 2048: 2048, "logits": 1008, "logits_unbiased": 1008}
_WEIGHTS_ENV = "METRICS_TPU_INCEPTION_WEIGHTS"


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm over channels with fixed statistics (inference only)."""

    def __init__(self, channels: int, eps: float = 1e-3) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(channels), requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: Tensor) -> Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)


class BasicConv2d(nn.Module):
    """Conv (no bias) + frozen BatchNorm (eps 1e-3) + ReLU, the TF-slim conv unit."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Any, stride: int = 1, padding: Any = 0) -> None:
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=False)
        self.bn = FrozenBatchNorm2d(out_ch)

    def forward(self, x: Tensor) -> Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_3x3(x: Tensor) -> Tensor:
    """3 x 3 stride-1 average pool, pad 1, dividing by the valid elements."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int) -> None:
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = F.max_pool2d(x, 3, stride=2)
        return torch.cat([b3, bd, bp], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, channels_7x7: int) -> None:
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = conv(bd)
        bp = self.branch_pool(_avg_pool_3x3(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int) -> None:
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        bp = F.max_pool2d(x, 3, stride=2)
        return torch.cat([b3, b7, bp], dim=1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int, pool_type: str) -> None:
        super().__init__()
        self.pool_type = pool_type  # "avg" (Mixed_7b) or "max" (Mixed_7c), the FID variant's split
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = _avg_pool_3x3(x) if self.pool_type == "avg" else F.max_pool2d(x, 3, stride=1, padding=1)
        bp = self.branch_pool(bp)
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionV3(nn.Module):
    """The FID variant of InceptionV3 on ``(N, 3, 299, 299)`` inputs in [-1, 1].

    ``forward(x)`` returns every tap; ``forward(x, tap)`` runs only as deep as
    ``tap`` needs and returns it.
    """

    def __init__(self) -> None:
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.fc = nn.Linear(2048, 1008)

    def forward(self, x: Tensor, tap: Any = None) -> Union[Tensor, Dict[Any, Tensor]]:
        out: Dict[Any, Tensor] = {}

        def done(key: Any, value: Tensor) -> bool:
            out[key] = value
            return tap == key

        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        if done(64, x.mean(dim=(2, 3))):
            return out[64]
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        if done(192, x.mean(dim=(2, 3))):
            return out[192]
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e):
            x = block(x)
        if done(768, x.mean(dim=(2, 3))):
            return out[768]
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        pooled = x.mean(dim=(2, 3))
        if done(2048, pooled):
            return pooled
        out["logits"] = self.fc(pooled)
        # the Inception Score's convention: the weight alone (the bias cancels in softmax ratios)
        out["logits_unbiased"] = pooled @ self.fc.weight.T
        return out if tap is None else out[tap]


def init_params(seed: int = 0) -> Dict[str, Tensor]:
    """The port's seeded random weights as a CPU ``state_dict``: He-normal conv
    kernels, identity BatchNorm, a fc of variance 1/2048 and zero bias, drawn
    from a CPU ``torch.Generator`` in parameter order (not the JAX package's
    flax initialisation, which the port cannot reproduce without JAX)."""
    gen = torch.Generator().manual_seed(seed)
    state = InceptionV3().state_dict()
    for key, value in state.items():
        if key.endswith("conv.weight"):
            state[key] = torch.randn(value.shape, generator=gen) * (2.0 / value[0].numel()) ** 0.5
        elif key == "fc.weight":
            state[key] = torch.randn(value.shape, generator=gen) * (1.0 / value.shape[1]) ** 0.5
        else:  # identity BatchNorm, zero fc bias
            state[key] = torch.ones_like(value) if key.endswith(("bn.weight", "running_var")) else torch.zeros_like(value)
    return state


@functools.lru_cache(maxsize=4)
def _cached_state(weights_path: Optional[str], seed: int) -> Dict[str, Tensor]:
    if weights_path is not None:
        return inception_params_from_jax(load_params(weights_path))
    rank_zero_warn(
        "InceptionV3 is using seeded RANDOM weights (allow_random_weights=True, no"
        " weights file). FID/KID/IS values will be self-consistent but NOT comparable"
        " to published numbers."
    )
    return init_params(seed)


@functools.lru_cache(maxsize=4)
def _cached_net(weights_path: Optional[str], seed: int, device: torch.device) -> InceptionV3:
    """One network a (weights, device): FID, KID and IS instances share it."""
    net = InceptionV3()
    net.load_state_dict(_cached_state(weights_path, seed), strict=True)
    return net.requires_grad_(False).eval().to(device)


def _forward(net: InceptionV3, tap: Any, imgs: Tensor) -> Tensor:
    """``imgs`` (N, C, H, W) resized to 299 x 299, mapped to [-1, 1], and ``tap``."""
    x = torch.as_tensor(imgs).to(next(net.parameters()).device, torch.float32)
    with torch.no_grad(), _float32_convolutions():
        x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False, antialias=True)
        x = x / 255.0 * 2.0 - 1.0
        return net(x, tap)


class InceptionFeatureExtractor:
    """Callable ``imgs (N, C, H, W) uint8/float -> (N, d)`` features on ``device``.

    Resizes to 299 x 299 (bilinear, antialiased), maps to [-1, 1], runs the
    network and returns the requested tap.
    """

    def __init__(
        self,
        feature: Any = 2048,
        weights_path: Optional[str] = None,
        seed: int = 0,
        allow_random_weights: bool = False,
        device: DeviceLike = None,
    ) -> None:
        if feature not in FEATURE_DIMS:
            raise ValueError(f"`feature` must be one of {sorted(FEATURE_DIMS, key=str)}, got {feature}")
        self.feature = feature
        self.num_features = FEATURE_DIMS[feature]
        weights_path = weights_path or os.environ.get(_WEIGHTS_ENV) or None
        if weights_path is not None and not os.path.exists(weights_path):
            raise FileNotFoundError(f"Inception weights file not found: {weights_path}")
        if weights_path is None and not allow_random_weights:
            raise FileNotFoundError(
                "No InceptionV3 weights available: pass `weights_path=`, set"
                " $METRICS_TPU_INCEPTION_WEIGHTS (a flat .npz in the JAX package's"
                " format), or opt into random initialisation with `allow_random_weights=True`"
                " (tests/relative comparisons only)."
            )
        self.net = _cached_net(weights_path, seed, resolve_device(device))

    def __call__(self, imgs: Tensor) -> Tensor:
        return _forward(self.net, self.feature, imgs)
