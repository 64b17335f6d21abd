"""Carry parameters and metric states from the JAX package into the port.

Both functions take plain numpy trees (``np.asarray`` of every JAX leaf), so
nothing here imports JAX. Leaves are copied: arrays exported by JAX are read-only.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.utils.device import DeviceLike, resolve_device


def params_from_jax(tree_of_numpy: Mapping[str, Any], device: DeviceLike = None) -> Dict[str, Union[Tensor, List[Tensor]]]:
    """The flagship MLP's parameters (``{"ws": [w, ...], "head": w}``) as float32 tensors.

    The JAX layout is kept: every weight is ``(fan_in, fan_out)`` and applied as
    ``h @ w``, exactly as ``bench.py`` applies it, so no weight is transposed.
    """
    dev = resolve_device(device)

    def conv(x: Any) -> Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32, copy=True)).to(dev)

    return {k: [conv(w) for w in v] if isinstance(v, (list, tuple)) else conv(v) for k, v in tree_of_numpy.items()}


def metric_state_from_jax(state_of_numpy: Mapping[str, Any], device: DeviceLike = None) -> Dict[str, Any]:
    """A functional metric state (``Metric.init_state()`` layout) as tensors.

    Dtypes are kept as they are, so int32 counts and ``_update_count`` stay
    int32; list states become lists of tensors.
    """
    dev = resolve_device(device)

    def conv(x: Any) -> Tensor:
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return {k: [conv(v) for v in val] if isinstance(val, (list, tuple)) else conv(val) for k, val in state_of_numpy.items()}
