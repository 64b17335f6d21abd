"""Shared helpers (port of ``metrics_tpu/utils``).

``__all__`` holds the names of ``metrics_tpu.utils.__all__`` that the port
defines; ``reduce``, ``class_reduce``, ``rank_zero_info``, ``rank_zero_debug``
and ``check_forward_full_state_property`` come with the domains that need them.
"""

from metrics_tpu_torch.utils.data import (
    apply_to_collection,
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
)
from metrics_tpu_torch.utils.prints import rank_zero_warn

__all__ = [
    "apply_to_collection",
    "dim_zero_cat",
    "dim_zero_max",
    "dim_zero_mean",
    "dim_zero_min",
    "dim_zero_sum",
    "rank_zero_warn",
]
