"""Cross-process gather (port of ``metrics_tpu/utils/distributed.py:60-93``).

On one process ``gather_all_tensors`` is the identity wrap. Once
``torch.distributed`` is initialised it all-gathers with the pad-to-max-then-trim
protocol: shapes are gathered first; equal shapes take one plain all-gather,
ragged shapes are zero-padded to the elementwise max, gathered, and each
rank's slice is trimmed back to its own shape. The comm plane of the JAX
package (``metrics_tpu/comm``) is not ported yet.
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


def gather_all_tensors(result: Tensor, group: Optional[Any] = None) -> List[Tensor]:
    """Gather ``result`` from every rank into a list ordered by rank.

    Every rank must pass a tensor of the same number of dimensions; the sizes
    of those dimensions may differ.
    """
    if not distributed_available():
        return [result]
    dist = torch.distributed
    world_size = dist.get_world_size(group)
    result = result.contiguous()

    local_size = torch.tensor(result.shape, dtype=torch.int64, device=result.device)
    sizes = [torch.zeros_like(local_size) for _ in range(world_size)]
    dist.all_gather(sizes, local_size, group=group)
    if all(torch.equal(s, local_size) for s in sizes):
        out = [torch.zeros_like(result) for _ in range(world_size)]
        dist.all_gather(out, result, group=group)
        return out

    max_size = torch.stack(sizes).amax(dim=0)
    pad = []
    for dim in reversed(range(result.ndim)):  # F.pad takes the last dim first
        pad.extend([0, int(max_size[dim] - local_size[dim])])
    padded = torch.nn.functional.pad(result, pad)
    out = [torch.zeros_like(padded) for _ in range(world_size)]
    dist.all_gather(out, padded, group=group)
    return [t[tuple(slice(0, int(n)) for n in size)] for t, size in zip(out, sizes)]
