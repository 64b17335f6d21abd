"""Shared helpers (port of ``metrics_tpu/utils``).

``__all__`` holds every name of ``metrics_tpu.utils.__all__``.
"""

from metrics_tpu_torch.utils.checks import check_forward_full_state_property
from metrics_tpu_torch.utils.data import (
    apply_to_collection,
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
)
from metrics_tpu_torch.utils.distributed import class_reduce, reduce
from metrics_tpu_torch.utils.prints import rank_zero_debug, rank_zero_info, rank_zero_warn

__all__ = [
    "apply_to_collection",
    "check_forward_full_state_property",
    "class_reduce",
    "dim_zero_cat",
    "dim_zero_max",
    "dim_zero_mean",
    "dim_zero_min",
    "dim_zero_sum",
    "rank_zero_debug",
    "rank_zero_info",
    "rank_zero_warn",
    "reduce",
]
