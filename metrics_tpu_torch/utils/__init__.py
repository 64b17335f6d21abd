"""Shared helpers (port of ``metrics_tpu/utils``)."""
