"""metrics_tpu_torch: the PyTorch and CUDA port of ``metrics_tpu``.

The package mirrors ``metrics_tpu``'s module paths so each port sits where its
reference does. It imports ``torch`` and numpy only, never JAX nor any module
of ``metrics_tpu``. States are tensors on an explicit device; entry points run
on the GPU unless the caller passes ``device="cpu"``.

Where ``metrics_tpu`` ran a Pallas kernel, the port runs a CUDA kernel written
for Hopper (``csrc/``), built with ``nvcc`` at first use. On a CUDA tensor the
kernel runs or the call raises; the kernel's plain PyTorch version serves CPU
tensors only.
"""

__version__ = "0.1.0"

from metrics_tpu_torch import functional
from metrics_tpu_torch.aggregation import CatMetric, MaxMetric, MeanMetric, MinMetric, SumMetric
from metrics_tpu_torch.classification import AUROC, ROC, AveragePrecision, PrecisionRecallCurve
from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import CompositionalMetric, Metric
from metrics_tpu_torch.sketch import CardinalitySketch, HeavyHittersSketch, QuantileSketch
from metrics_tpu_torch import engine  # noqa: E402  (serving runtime; not in __all__, as in the JAX package)

# the names of ``metrics_tpu.__all__`` that the port has so far
__all__ = [
    "functional",
    "AUROC",
    "AveragePrecision",
    "CardinalitySketch",
    "CatMetric",
    "CompositionalMetric",
    "HeavyHittersSketch",
    "MaxMetric",
    "MeanMetric",
    "Metric",
    "MetricCollection",
    "MinMetric",
    "PrecisionRecallCurve",
    "QuantileSketch",
    "ROC",
    "SumMetric",
]
