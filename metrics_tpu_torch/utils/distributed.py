"""Reductions and the cross-process gather (port of ``metrics_tpu/utils/distributed.py``).

``reduce`` and ``class_reduce`` reduce a tensor as the reference's
``utilities/distributed.py`` does (``jnp.mean`` becomes ``torch.mean``, which
may differ from it in the last bit of a float32 mean).

``gather_all_tensors`` rides the comm plane's transport layer
(:func:`metrics_tpu_torch.comm.transport.gather_ragged`): shapes are gathered
first; equal shapes take one all-gather, ragged shapes are zero-padded to the
elementwise max, gathered and trimmed back to each rank's shape — or, when the
transport can broadcast and padding would ship more than 1.25x the payload,
each rank broadcasts its exact buffer instead. Ranks that pass tensors of
different ``ndim`` raise, as in the reference protocol. On one process it is
the identity wrap.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.utils.compute import _safe_divide


def reduce(x: Tensor, reduction: Optional[str]) -> Tensor:
    """Reduce a tensor: ``"elementwise_mean"``, ``"sum"``, or ``"none"`` / None."""
    if reduction == "elementwise_mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    if reduction is None or reduction == "none":
        return x
    raise ValueError("Reduction parameter unknown.")


def class_reduce(num: Tensor, denom: Tensor, weights: Tensor, class_reduction: str = "none") -> Tensor:
    """Per-class fraction ``num / denom`` (0 where ``denom`` is 0), reduced by
    ``"micro"``, ``"macro"``, ``"weighted"`` or ``"none"`` / None."""
    valid_reduction = ("micro", "macro", "weighted", "none", None)
    fraction = _safe_divide(torch.sum(num), torch.sum(denom)) if class_reduction == "micro" else _safe_divide(num, denom)

    if class_reduction == "micro":
        return fraction
    if class_reduction == "macro":
        return torch.mean(fraction)
    if class_reduction == "weighted":
        return torch.sum(fraction * _safe_divide(weights, torch.sum(weights)))
    if class_reduction == "none" or class_reduction is None:
        return fraction
    raise ValueError(f"Reduction parameter {class_reduction} unknown. Choose between one of these: {valid_reduction}")


def distributed_available() -> bool:
    """True when ``torch.distributed`` is initialised with more than one rank."""
    return (
        torch.distributed.is_available()
        and torch.distributed.is_initialized()
        and torch.distributed.get_world_size() > 1
    )


def gather_all_tensors(result: Tensor, group: Optional[Any] = None, *, transport: Optional[Any] = None) -> List[Tensor]:
    """Gather ``result`` from every rank into a list ordered by rank.

    Every rank must pass a tensor of the same number of dimensions; the sizes
    of those dimensions may differ. The rows come back on ``result``'s device.
    ``transport`` is injectable for tests and custom fabrics; the default is
    the process-wide comm transport, or a :class:`~metrics_tpu_torch.comm.MultihostTransport`
    over ``group`` (default: the whole world).
    """
    from metrics_tpu_torch.comm import plane as _plane
    from metrics_tpu_torch.comm.plan import device_tensor, host_array
    from metrics_tpu_torch.comm.transport import MultihostTransport, gather_ragged

    if transport is None:
        if not distributed_available():
            return [result]
        transport = _plane.get_config().transport
        if transport is None:
            transport = MultihostTransport(group) if group is not None else _plane.default_transport()
    rows = gather_ragged(transport, host_array(result), rank=getattr(transport, "rank", None))
    return [device_tensor(r, result.device) for r in rows]


def default_dist_sync_fn(result: Tensor, group: Optional[Any] = None) -> List[Tensor]:
    """The default ``dist_sync_fn`` used by :class:`metrics_tpu_torch.Metric`."""
    return gather_all_tensors(result, group)
