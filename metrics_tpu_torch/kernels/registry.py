"""Dispatch registry for the kernel plane (port of ``metrics_tpu/kernels/registry.py``).

Every entry pairs an **optimized** implementation (a wrapper that launches a
CUDA kernel) with the plain PyTorch **reference** it must be value-identical
to: bit-identical on integer/count states.

Selection is by device plus static eligibility:

- the call's tensors lie on the CPU: the reference runs.
- otherwise: the optimized wrapper runs (on a CUDA tensor it launches its
  kernel; on any other device it raises). If the call is not eligible,
  :func:`dispatch` raises; it never runs the reference off the CPU.

A call whose tensors are batched by ``torch.func.vmap`` (``BootStrapper``'s
stacked update) goes to the optimized wrapper on either device: the wrapper
sends it through its custom op, whose batching rule calls the wrapper once a
copy, so each CUDA copy launches the kernel and each CPU copy runs the
reference (:mod:`._batched`).

Two things of the JAX registry are deliberately absent. There is no exception
fallback (``metrics_tpu/kernels/registry.py:206-215`` ran the reference after
any kernel failure): on a CUDA tensor the kernel runs or the call raises, so a
broken kernel shows at once. And there is no mode environment variable that
could route a CUDA call to the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from metrics_tpu_torch.kernels import _batched
from metrics_tpu_torch.obs import instrument as _obs


@dataclass(frozen=True)
class KernelEntry:
    """One registry entry: a kernel wrapper bound to its plain reference.

    ``optimized`` takes the same arguments as ``reference``. ``eligible`` sees
    the call's ``(*args, **kwargs)`` and decides from shapes, dtypes and Python
    values only, never from tensor contents.
    """

    name: str
    reference: Callable[..., Any]
    optimized: Callable[..., Any]
    eligible: Callable[..., bool] = field(default=lambda *a, **k: True)


REGISTRY: Dict[str, KernelEntry] = {}


def register(entry: KernelEntry) -> KernelEntry:
    """Install one entry (re-registration under the same name replaces)."""
    REGISTRY[entry.name] = entry
    return entry


def get(name: str) -> KernelEntry:
    return REGISTRY[name]


def names() -> Tuple[str, ...]:
    return tuple(REGISTRY)


def _device_of(args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> Optional[torch.device]:
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            return a.device
    return None


def selected(name: str, *args: Any, **kwargs: Any) -> str:
    """Which impl :func:`dispatch` takes: ``"optimized"`` | ``"reference"``.

    Raises ``ValueError`` for a non-CPU call the kernel is not eligible for.
    """
    entry = REGISTRY[name]
    device = _device_of(args, kwargs)
    if device is None or device.type == "cpu":
        return "reference"
    if not entry.eligible(*args, **kwargs):
        raise ValueError(
            f"kernel entry {name!r} is not eligible for this call on {device}; "
            "the plain reference runs on CPU tensors only"
        )
    return "optimized"


def dispatch(name: str, *args: Any, **kwargs: Any) -> Any:
    """Run entry ``name``: its kernel on CUDA tensors, its reference otherwise."""
    entry = REGISTRY[name]
    if _batched.is_batched(*args, *kwargs.values()):
        _obs.record_kernel_dispatch(name, "batched")
        return entry.optimized(*args, **kwargs)
    impl = selected(name, *args, **kwargs)
    _obs.record_kernel_dispatch(name, impl)
    fn = entry.optimized if impl == "optimized" else entry.reference
    return fn(*args, **kwargs)
