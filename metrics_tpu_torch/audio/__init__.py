"""Audio module metrics (port of ``metrics_tpu/audio``)."""

from metrics_tpu_torch.audio.pesq import PerceptualEvaluationSpeechQuality
from metrics_tpu_torch.audio.pit import PermutationInvariantTraining
from metrics_tpu_torch.audio.sdr import ScaleInvariantSignalDistortionRatio, SignalDistortionRatio
from metrics_tpu_torch.audio.snr import ScaleInvariantSignalNoiseRatio, SignalNoiseRatio
from metrics_tpu_torch.audio.stoi import ShortTimeObjectiveIntelligibility

__all__ = [
    "PermutationInvariantTraining",
    "PerceptualEvaluationSpeechQuality",
    "ScaleInvariantSignalDistortionRatio",
    "ScaleInvariantSignalNoiseRatio",
    "ShortTimeObjectiveIntelligibility",
    "SignalDistortionRatio",
    "SignalNoiseRatio",
]
