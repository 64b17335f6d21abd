"""Input validation helpers (port of ``metrics_tpu/utils/checks.py``, the part
that the ported classification validation calls).

The JAX package skips value-dependent checks on traced arrays. The torch
analogues of a trace are ``torch.compile`` and CUDA-graph capture (the serving
engine captures each micro-batch): while either records, a check that reads
tensor values on the host would break the graph (a host read inside a capture
is an error), so those checks are skipped there too.
"""

from __future__ import annotations

import torch
from torch import Tensor


def _value_check_possible(*tensors: Tensor) -> bool:
    """True unless ``torch.compile`` is tracing or the current CUDA stream is
    being captured into a graph (value-dependent checks may run)."""
    if torch.compiler.is_compiling():
        return False
    on_card = any(isinstance(t, Tensor) and t.is_cuda for t in tensors)
    return not (on_card and torch.cuda.is_current_stream_capturing())


def _check_same_shape(preds: Tensor, target: Tensor) -> None:
    """Raise if the shapes differ."""
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, but got {preds.shape} and {target.shape}."
        )
