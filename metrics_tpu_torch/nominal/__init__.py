"""Nominal association module metrics (port of ``metrics_tpu/nominal``)."""

from metrics_tpu_torch.nominal.stats import CramersV, PearsonsContingencyCoefficient, TheilsU, TschuprowsT

__all__ = ["CramersV", "PearsonsContingencyCoefficient", "TheilsU", "TschuprowsT"]
