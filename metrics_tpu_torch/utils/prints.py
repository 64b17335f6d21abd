"""Rank-zero-only warnings and log records (port of ``metrics_tpu/utils/prints.py``).

Log records go to the ``metrics_tpu_torch`` logger. The rank is ``torch.distributed.get_rank()`` once a process group is
initialised, else the ``LOCAL_RANK`` environment variable (0 when unset).
"""

from __future__ import annotations

import logging
import os
import warnings
from functools import wraps
from typing import Any, Callable

import torch

log = logging.getLogger("metrics_tpu_torch")


def _rank() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return int(os.environ.get("LOCAL_RANK", 0))


def rank_zero_only(fn: Callable) -> Callable:
    """Run ``fn`` only on rank 0 of a multi-process job."""

    @wraps(fn)
    def wrapped_fn(*args: Any, **kwargs: Any) -> Any:
        if _rank() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped_fn


@rank_zero_only
def _warn(message: str, *args: Any, **kwargs: Any) -> None:
    warnings.warn(message, *args, **kwargs)


@rank_zero_only
def _info(message: str, **kwargs: Any) -> None:
    log.info(message, **kwargs)


@rank_zero_only
def _debug(message: str, **kwargs: Any) -> None:
    log.debug(message, **kwargs)


rank_zero_warn = _warn
rank_zero_info = _info
rank_zero_debug = _debug


_warn_once_registry: set = set()


def rank_zero_warn_once(message: str) -> None:
    """:func:`rank_zero_warn` the first time this process sees ``message``."""
    if message not in _warn_once_registry:
        _warn_once_registry.add(message)
        rank_zero_warn(message)
