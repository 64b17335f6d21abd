"""The LPIPS network (port of ``metrics_tpu/image/lpips_net.py``): a frozen
backbone (``alex``, ``vgg`` or ``squeeze``) whose taps are unit-normalised
over channels (eps 1e-10), squared differences weighted by learned
non-negative 1 x 1 heads (``|w|``), a spatial mean, and the sum over taps.

The backbones are ``nn.Module``s in NCHW with the JAX package's layer names
(``features.conv1``, ``features.fire2.squeeze``, ...), and the heads are
``(C, 1)`` parameters ``lin0``, ``lin1``, ..., so
``utils.params_io.lpips_params_from_jax`` maps a JAX weights file onto the
``state_dict`` one for one. SqueezeNet 1.1's pools keep a last window that
hangs over the edge (``nn.MaxPool2d(ceil_mode=True)``, the JAX package's
``-inf`` pad). The convolutions run in full float32.

Weights: ``weights_path``, then ``$METRICS_TPU_LPIPS_WEIGHTS`` (a flat
``.npz`` in the JAX package's format), else ``FileNotFoundError`` unless
``allow_random_weights=True`` opts into the port's own seeded random
initialisation (a CPU ``torch.Generator``: the same weights on every device).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from metrics_tpu_torch.utils.compute import _float32_convolutions
from metrics_tpu_torch.utils.device import DeviceLike, resolve_device
from metrics_tpu_torch.utils.params_io import load_params, lpips_params_from_jax, save_params  # noqa: F401
from metrics_tpu_torch.utils.prints import rank_zero_warn

_WEIGHTS_ENV = "METRICS_TPU_LPIPS_WEIGHTS"

# ImageNet scaling layer constants (lpips ScalingLayer)
_SHIFT = np.array([-0.030, -0.088, -0.188], dtype=np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], dtype=np.float32)

# tap channel widths per backbone (lpips v0.1)
NET_CHANNELS = {
    "alex": (64, 192, 384, 256, 256),
    "vgg": (64, 128, 256, 512, 512),
    "squeeze": (64, 128, 256, 384, 384, 512, 512),
}


class AlexFeatures(nn.Module):
    """AlexNet feature stack, taps after each of the 5 ReLUs."""

    def __init__(self) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 11, stride=4, padding=2)
        self.conv2 = nn.Conv2d(64, 192, 5, padding=2)
        self.conv3 = nn.Conv2d(192, 384, 3, padding=1)
        self.conv4 = nn.Conv2d(384, 256, 3, padding=1)
        self.conv5 = nn.Conv2d(256, 256, 3, padding=1)

    def forward(self, x: Tensor) -> List[Tensor]:
        taps = [F.relu(self.conv1(x))]
        taps.append(F.relu(self.conv2(F.max_pool2d(taps[-1], 3, 2))))
        taps.append(F.relu(self.conv3(F.max_pool2d(taps[-1], 3, 2))))
        taps.append(F.relu(self.conv4(taps[-1])))
        taps.append(F.relu(self.conv5(taps[-1])))
        return taps


class VGG16Features(nn.Module):
    """VGG16 stack, taps after relu1_2, relu2_2, relu3_3, relu4_3, relu5_3."""

    _CFG = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

    def __init__(self) -> None:
        super().__init__()
        prev = 3
        for stage, (width, n_convs) in enumerate(self._CFG, start=1):
            for i in range(1, n_convs + 1):
                self.add_module(f"conv{stage}_{i}", nn.Conv2d(prev, width, 3, padding=1))
                prev = width

    def forward(self, x: Tensor) -> List[Tensor]:
        taps = []
        for stage, (_, n_convs) in enumerate(self._CFG, start=1):
            for i in range(1, n_convs + 1):
                x = F.relu(getattr(self, f"conv{stage}_{i}")(x))
            taps.append(x)
            if stage < 5:
                x = F.max_pool2d(x, 2, 2)
        return taps


class Fire(nn.Module):
    """SqueezeNet fire module: squeeze 1x1, then expand 1x1 and 3x3, concatenated."""

    def __init__(self, in_ch: int, squeeze: int, expand: int) -> None:
        super().__init__()
        self.squeeze = nn.Conv2d(in_ch, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x: Tensor) -> Tensor:
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)), F.relu(self.expand3x3(s))], dim=1)


class SqueezeFeatures(nn.Module):
    """SqueezeNet 1.1 stack with the 7 LPIPS taps."""

    def __init__(self) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, stride=2)
        self.pool = nn.MaxPool2d(3, 2, ceil_mode=True)  # torchvision's squeezenet1_1 pools
        for name, (cin, s, e) in {"fire2": (64, 16, 64), "fire3": (128, 16, 64), "fire4": (128, 32, 128),
                                  "fire5": (256, 32, 128), "fire6": (256, 48, 192), "fire7": (384, 48, 192),
                                  "fire8": (384, 64, 256), "fire9": (512, 64, 256)}.items():
            self.add_module(name, Fire(cin, s, e))

    def forward(self, x: Tensor) -> List[Tensor]:
        taps = [F.relu(self.conv1(x))]
        x = self.fire3(self.fire2(self.pool(taps[-1])))
        taps.append(x)
        x = self.fire5(self.fire4(self.pool(x)))
        taps.append(x)
        x = self.pool(x)
        for fire in (self.fire6, self.fire7, self.fire8, self.fire9):
            x = fire(x)
            taps.append(x)
        return taps


_BACKBONES = {"alex": AlexFeatures, "vgg": VGG16Features, "squeeze": SqueezeFeatures}


class LPIPSNet(nn.Module):
    """Backbone, unit-normalised taps, squared difference, learned 1 x 1 heads,
    spatial mean; ``forward(img0, img1)`` on (N, 3, H, W) in [-1, 1] gives (N,)."""

    def __init__(self, net_type: str = "alex") -> None:
        super().__init__()
        self.net_type = net_type
        self.features = _BACKBONES[net_type]()
        for i, width in enumerate(NET_CHANNELS[net_type]):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.zeros(width, 1)))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1), persistent=False)

    def forward(self, img0: Tensor, img1: Tensor) -> Tensor:
        with _float32_convolutions():
            taps0 = self.features((img0.to(torch.float32) - self.shift) / self.scale)
            taps1 = self.features((img1.to(torch.float32) - self.shift) / self.scale)
        total = torch.zeros(img0.shape[0], dtype=torch.float32, device=img0.device)
        for i, (f0, f1) in enumerate(zip(taps0, taps1)):
            f0 = f0 / torch.clamp(torch.linalg.vector_norm(f0, dim=1, keepdim=True), min=1e-10)
            f1 = f1 / torch.clamp(torch.linalg.vector_norm(f1, dim=1, keepdim=True), min=1e-10)
            head = torch.abs(getattr(self, f"lin{i}")).view(1, -1, 1, 1)  # |w| keeps the head a distance
            total = total + torch.mean(torch.sum((f0 - f1) ** 2 * head, dim=1), dim=(1, 2))
        return total


def init_params(net_type: str = "alex", seed: int = 0) -> Dict[str, Tensor]:
    """The port's seeded random weights as a CPU ``state_dict``: He-normal conv
    kernels, zero biases, heads uniform in [0, 0.1), drawn from a CPU
    ``torch.Generator`` in parameter order (not the JAX package's flax
    initialisation)."""
    gen = torch.Generator().manual_seed(seed)
    state = LPIPSNet(net_type).state_dict()
    for key, value in state.items():
        if key.endswith("weight"):
            state[key] = torch.randn(value.shape, generator=gen) * (2.0 / value[0].numel()) ** 0.5
        elif key.startswith("lin"):
            state[key] = torch.rand(value.shape, generator=gen) * 0.1
        else:
            state[key] = torch.zeros_like(value)
    return state


def make_distance_fn(
    net_type: str = "alex",
    weights_path: Optional[str] = None,
    seed: int = 0,
    allow_random_weights: bool = False,
    device: DeviceLike = None,
) -> Callable[[Tensor, Tensor], Tensor]:
    """``(img0, img1) -> (N,)`` perceptual distances on ``device``.

    Weight resolution: ``weights_path``, then ``$METRICS_TPU_LPIPS_WEIGHTS``,
    else an error unless ``allow_random_weights=True`` opts into seeded random
    weights (self-consistent, not comparable to published LPIPS numbers). A
    weights file of another backbone raises ``ValueError``.
    """
    if net_type not in _BACKBONES:
        raise ValueError(f"Argument `net_type` must be one of {tuple(_BACKBONES)}, but got {net_type}.")
    path = weights_path or os.environ.get(_WEIGHTS_ENV)
    net = LPIPSNet(net_type)
    if path:
        try:
            net.load_state_dict(lpips_params_from_jax(load_params(path), net_type), strict=True)
        except (KeyError, RuntimeError, ValueError) as err:
            raise ValueError(
                f"LPIPS weights at {path!r} do not match net_type={net_type!r}"
                " (wrong backbone or corrupted file)."
            ) from err
    elif allow_random_weights:
        rank_zero_warn(
            "LPIPS is using seeded RANDOM weights (allow_random_weights=True, no weights file)."
            " Distances are self-consistent but NOT comparable to published LPIPS numbers."
        )
        net.load_state_dict(init_params(net_type, seed=seed), strict=True)
    else:
        raise FileNotFoundError(
            "No LPIPS weights available: pass `weights_path=`, set $METRICS_TPU_LPIPS_WEIGHTS,"
            " or opt into random initialisation with `allow_random_weights=True`"
            " (tests/relative comparisons only)."
        )
    net = net.requires_grad_(False).eval().to(resolve_device(device))

    def distance(img0: Any, img1: Any) -> Tensor:
        return net(torch.as_tensor(img0), torch.as_tensor(img1))

    return distance
