"""Device resolution shared by the port's entry points.

Entry points run on the GPU unless the caller asks for another device:
``device=None`` means ``"cuda"``, and without a usable GPU that is an error,
never a silent move to the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` resolves to ``cuda``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "metrics_tpu_torch runs on the GPU by default, but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
