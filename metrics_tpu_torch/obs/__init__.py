"""Observability (port of ``metrics_tpu/obs``: the master gate, the registry and
the series of the metric core, the kernel plane and the engine's durable, guard
and tier planes; tracing, the flight recorder and fleet telemetry are not ported
yet)."""

from metrics_tpu_torch.obs.registry import OBS, REGISTRY


def enable() -> None:
    OBS.enabled = True


def disable() -> None:
    OBS.enabled = False


__all__ = ["OBS", "REGISTRY", "enable", "disable"]
