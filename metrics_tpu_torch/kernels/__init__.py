"""Kernel plane (port of ``metrics_tpu/kernels``): hand-written CUDA kernels for
Hopper, each beside its plain PyTorch version, routed by :mod:`.registry`.
Importing the package registers every entry."""

from metrics_tpu_torch.kernels import binned_curve, confmat, scatter

__all__ = ["binned_curve", "confmat", "scatter"]
