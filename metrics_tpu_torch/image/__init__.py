"""Image module metrics (port of ``metrics_tpu/image``).

``__all__`` holds the JAX package's names but the four that need a network
(``FrechetInceptionDistance``, ``InceptionScore``,
``KernelInceptionDistance``, ``LearnedPerceptualImagePatchSimilarity``),
which the next slice ports with their nets.
"""

from metrics_tpu_torch.image.d_lambda import SpectralDistortionIndex
from metrics_tpu_torch.image.ergas import ErrorRelativeGlobalDimensionlessSynthesis
from metrics_tpu_torch.image.psnr import PeakSignalNoiseRatio
from metrics_tpu_torch.image.sam import SpectralAngleMapper
from metrics_tpu_torch.image.ssim import (
    MultiScaleStructuralSimilarityIndexMeasure,
    StructuralSimilarityIndexMeasure,
)
from metrics_tpu_torch.image.tv import TotalVariation
from metrics_tpu_torch.image.uqi import UniversalImageQualityIndex

__all__ = [
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "StructuralSimilarityIndexMeasure",
    "TotalVariation",
    "UniversalImageQualityIndex",
]
