"""Kernel plane (port of ``metrics_tpu/kernels``): hand-written CUDA kernels for
Hopper, each beside its plain PyTorch version, routed by :mod:`.registry`.
Importing the package registers every entry."""

from typing import Dict

from metrics_tpu_torch.kernels import binned_curve, cms_walk, confmat, engine_scan, scatter


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


__all__ = ["binned_curve", "cms_walk", "confmat", "engine_scan", "launch_counts", "scatter"]
