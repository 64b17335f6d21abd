"""Input validation helpers (port of ``metrics_tpu/utils/checks.py``, the part
that the ported classification validation calls).

The JAX package skips value-dependent checks on traced arrays: inside
``jax.jit``, and so inside the serving engine's micro-batch kernel and
``Metric.jitted_update_state``. The port skips them in each torch analogue of
a trace: ``torch.compile``, CUDA-graph capture (a host read inside a capture
is an error), and every run of the code that a trace stands for, marked with
:func:`traced`: the engine's micro-batch scan (on the CPU a loop, on the card
the warm-up and the capture of its graph) and the graphed updater (its CPU
path, its warm-up and its capture). So a request is judged the same before a
graph exists and after, and the same on the CPU and on the card. The eager
paths (``update``, ``update_state``, the engine's eager retry and its demoted
path) keep their checks, as the JAX package's eager path keeps its own.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator

import torch
from torch import Tensor

_TRACE = threading.local()


@contextmanager
def traced() -> Iterator[None]:
    """Run the body as the JAX package runs a traced function: value-dependent
    checks are skipped on this thread until the body ends."""
    outer = getattr(_TRACE, "on", False)
    _TRACE.on = True
    try:
        yield
    finally:
        _TRACE.on = outer


def _value_check_possible(*tensors: Tensor) -> bool:
    """True unless a :func:`traced` body runs on this thread, ``torch.compile``
    is tracing, or the current CUDA stream is being captured into a graph
    (value-dependent checks may run)."""
    if getattr(_TRACE, "on", False) or torch.compiler.is_compiling():
        return False
    on_card = any(isinstance(t, Tensor) and t.is_cuda for t in tensors)
    return not (on_card and torch.cuda.is_current_stream_capturing())


def _check_same_shape(preds: Tensor, target: Tensor) -> None:
    """Raise if the shapes differ."""
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, but got {preds.shape} and {target.shape}."
        )
