"""Sketch plane (port of ``metrics_tpu/sketch``): mergeable quantile,
cardinality and heavy-hitter metrics on fixed-shape int32 states.

- :mod:`metrics_tpu_torch.sketch.kernels`: the pure-functional kernel layer,
  whose scatters run the CUDA kernels of ``csrc/scatter.cu`` on the card;
- :class:`QuantileSketch` / :class:`CardinalitySketch` /
  :class:`HeavyHittersSketch`: the ``Metric`` subclasses;
- :mod:`metrics_tpu_torch.functional.sketch`: one-shot functional twins.
"""

from metrics_tpu_torch.sketch import kernels
from metrics_tpu_torch.sketch.metrics import CardinalitySketch, HeavyHittersSketch, QuantileSketch

__all__ = ["CardinalitySketch", "HeavyHittersSketch", "QuantileSketch", "kernels"]
