"""Batching rules of the hand kernels under ``torch.func.vmap``.

``BootStrapper``'s stacked update runs the base metric's ``update_state`` under
``torch.func.vmap`` over a stacked state (the JAX package's ``jax.vmap``).
Inside it the tensors are batched: they have no storage of their own, so a
kernel wrapper cannot hand their ``data_ptr()`` to its ``ctypes`` launch.
Each wrapper that a fixed-state update reaches therefore checks its tensors
first (:func:`is_batched`) and sends a batched call to a
``torch.library.custom_op`` of its own. The op's vmap rule (:func:`loop_rule`)
calls the wrapper once a copy on the copy's slices, so a CUDA copy launches
the kernel (counted by the wrapper, as any launch) and a CPU copy runs the
plain version, and stacks the results. A wrapper's unbatched call never
reaches the op: its only added cost is :func:`is_batched`, and a graph
capture sees the same launches as before.

One launch for all copies (labels offset by copy, ``b * C + class``) is later
work (ROADMAP B.2): the loop launches ``B`` times.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import torch
from torch import Tensor

_current_level = torch._C._functorch.maybe_current_level
_is_batched_tensor = torch._C._functorch.is_batchedtensor


def is_batched(*xs: Any) -> bool:
    """True when a functorch transform is active and one of ``xs`` is a
    tensor batched by it (one C call when no transform is active)."""
    if _current_level() is None:
        return False
    return any(isinstance(x, Tensor) and _is_batched_tensor(x) for x in xs)


def _slice(x: Any, dim: Any, b: int) -> Any:
    return x if dim is None else x.select(dim, b).contiguous()


def loop_rule(call: Callable[..., Any]) -> Callable[..., Tuple[Any, Any]]:
    """A vmap rule that runs ``call`` (the kernel's wrapper) on each copy's
    slices of the batched arguments, unbatched ones passed as they are, and
    stacks each output along a new dimension 0."""

    def rule(info: Any, in_dims: Sequence[Any], *args: Any) -> Tuple[Any, Any]:
        outs = [call(*(_slice(a, d, b) for a, d in zip(args, in_dims))) for b in range(info.batch_size)]
        if isinstance(outs[0], tuple):
            return tuple(torch.stack(o) for o in zip(*outs)), (0,) * len(outs[0])
        return torch.stack(outs), 0

    return rule
