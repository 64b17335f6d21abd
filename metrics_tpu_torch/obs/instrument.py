"""Instrumentation hooks of the kernel plane
(port of the kernel section of ``metrics_tpu/obs/instrument.py``).

Both hooks return at once while ``OBS.enabled`` is false. Unlike the JAX
package, whose callers are jitted and so count compiled lowerings, PyTorch runs
eagerly: these count calls.
"""

from __future__ import annotations

from metrics_tpu_torch.obs.registry import OBS, REGISTRY

KERNEL_DISPATCHES = REGISTRY.counter(
    "metrics_tpu_torch_kernel_dispatch_total",
    "Kernel-plane registry dispatches per entry and impl (optimized|reference), one per call.",
)
KERNEL_LAUNCHES = REGISTRY.counter(
    "metrics_tpu_torch_kernel_launches_total",
    "CUDA kernel launches per kernel, counted by the wrapper where it launches.",
)


def record_kernel_dispatch(name: str, impl: str) -> None:
    """Count one registry dispatch of entry ``name`` to ``impl``."""
    if not OBS.enabled:
        return
    KERNEL_DISPATCHES.inc(1, kernel=name, impl=impl)


def record_kernel_launch(name: str) -> None:
    """Count one launch of CUDA kernel ``name``."""
    if not OBS.enabled:
        return
    KERNEL_LAUNCHES.inc(1, kernel=name)
