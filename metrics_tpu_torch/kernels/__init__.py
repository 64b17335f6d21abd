"""Kernel plane (port of ``metrics_tpu/kernels``): hand-written CUDA kernels for
Hopper, each beside its plain PyTorch version, routed by :mod:`.registry`."""
