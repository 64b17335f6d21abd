"""Cross-process gather (port of ``metrics_tpu/utils/distributed.py:60-93``).

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
