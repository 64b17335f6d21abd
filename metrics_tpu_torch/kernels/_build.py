"""Build and load the CUDA kernels of ``metrics_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library, then loaded with ``ctypes``.
The build happens at first use, from the sources in the checkout, into
``build/metrics_tpu_torch/`` at the root of the checkout. The library's file
name carries a hash of the source, the headers in ``csrc/`` and the flags,
so an edited source or header rebuilds. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "metrics_tpu_torch"
NVCC_FLAGS: List[str] = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


class KernelLaunchError(RuntimeError):
    """A hand kernel's launch was refused (the C function returned a CUDA
    error). A ``RuntimeError``, so that callers which catch torch's own
    ``RuntimeError`` (``BootStrapper``'s fall-back from its stacked update)
    can tell a kernel's failure apart and let it through."""


_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for candidate in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found (neither on PATH nor at /usr/local/cuda/bin/nvcc); cannot build CUDA kernels")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives for this source
    and the headers beside it."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library for this source exists.

    ``nvcc``'s output (with ``-Xptxas -v``: registers, shared memory, spills
    per kernel) goes to a ``.log`` file beside the library.
    """
    lib = library_path(name)
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")],
            capture_output=True, text=True,
        )
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]
