"""Input validation helpers (port of ``metrics_tpu/utils/checks.py``, the part
that multiclass validation calls).

The JAX package skips value-dependent checks on traced arrays. The torch
analogue of a trace is ``torch.compile``: while it traces, a check that reads
tensor values would break the graph, so those checks are skipped there too.
"""

from __future__ import annotations

import torch
from torch import Tensor


def _value_check_possible(*tensors: Tensor) -> bool:
    """True unless ``torch.compile`` is tracing (value-dependent checks may run)."""
    return not torch.compiler.is_compiling()
