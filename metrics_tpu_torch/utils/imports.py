"""Optional-dependency availability flags (port of ``metrics_tpu/utils/imports.py``,
the flags the port uses). A flag looks the package up without importing it."""

from __future__ import annotations

import importlib.util


def _package_available(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, ModuleNotFoundError, ValueError):
        return False


_MATPLOTLIB_AVAILABLE = _package_available("matplotlib")
_SCIPY_AVAILABLE = _package_available("scipy")
_PESQ_AVAILABLE = _package_available("pesq")
_PYSTOI_AVAILABLE = _package_available("pystoi")
_LPIPS_AVAILABLE = _package_available("lpips")
