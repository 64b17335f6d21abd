"""Kernel plane (port of ``metrics_tpu/kernels``): hand-written CUDA kernels for
Hopper, each beside its plain PyTorch version, routed by :mod:`.registry`.
Importing the package registers every entry.

The registry's names are re-exported as the JAX package exports them, except
``configure``, ``mode`` and ``forced``: the port has no mode that routes a CUDA
tensor to a kernel's plain version, so it has nothing for them to set."""

from typing import Dict

from metrics_tpu_torch.kernels import binned_curve, cms_walk, confmat, engine_scan, registry, scatter
from metrics_tpu_torch.kernels.registry import REGISTRY, KernelEntry, dispatch, get, names, register, selected


def launch_counts() -> Dict[str, int]:
    """Every hand kernel's launch counter, by kernel name: what each wrapper
    counted where it launched. A wrapper runs once while a CUDA graph is
    captured, so these count captured launches; the engine multiplies them by
    its replays (``StreamingEngine.graph_launches``)."""
    return {
        "pair_count": confmat.launches,
        "stat_scores": confmat.stat_score_launches,
        **scatter.launches,
        "binned_curve": binned_curve.launches,
        "cms_walk": cms_walk.launches,
    }


__all__ = [
    "REGISTRY",
    "KernelEntry",
    "binned_curve",
    "cms_walk",
    "confmat",
    "dispatch",
    "engine_scan",
    "get",
    "launch_counts",
    "names",
    "register",
    "registry",
    "scatter",
    "selected",
]
