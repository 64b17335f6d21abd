"""State synchronisation across ranks (port of ``metrics_tpu/parallel/sync.py``).

Reducible states never gather — ``sum/mean/max/min`` are one ``all_reduce`` on
the state's own device (O(state) traffic against O(world·state) for
gather-then-reduce). Only ``cat``/``None`` states all-gather. Two execution
contexts, one API:

- **in a step** (each rank holds its shard, as inside the JAX package's
  ``shard_map``): :func:`reduce_in_trace` issues ``torch.distributed``
  collectives over ``axis_name``; this is how metric state fuses into a
  data-parallel training step (``Metric.sync_state``,
  ``Metric.compute_from(state, axis_name=...)``), and with NCCL the whole step
  can be captured in one CUDA graph;
- **host, multi-process**: :func:`sync_state_host` rides the comm plane
  (:mod:`metrics_tpu_torch.comm`): signature-cached transfer plans, per-state
  codecs, coalesced/chunked collectives, and a timeout → retry → degradation
  ladder.

What ``axis_name`` is in the port (a ``ProcessGroup``, or names of the
dimensions of a ``DeviceMesh`` installed with :func:`use_mesh`) is set out in
:mod:`metrics_tpu_torch.comm.axis`; :func:`use_mesh` and :func:`resolve_axis`
are re-exported here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.comm import plane as _plane
from metrics_tpu_torch.comm.axis import AxisName, resolve_axis, use_mesh
from metrics_tpu_torch.obs import instrument as _obs
from metrics_tpu_torch.obs.registry import OBS as _OBS

__all__ = ["in_trace", "reduce_in_trace", "resolve_axis", "sync_state_host", "use_mesh"]


def reduce_in_trace(x: Tensor, reduce_fx: Optional[Any], axis_name: AxisName, codec: Any = None) -> Tensor:
    """Apply one state reduction as a collective over ``axis_name``.

    ``cat``/``None`` → all-gather (tiled for cat: shards concatenate along dim
    0, matching the reference's dim-0 cat of the gathered list). Pass
    ``codec="int8"`` (or ``"fp16"``) to move gather-style payloads quantized
    through the collective and dequantize on the far side — see
    :func:`metrics_tpu_torch.comm.plane.reduce_in_trace`.
    """
    return _plane.reduce_in_trace(x, reduce_fx, axis_name, codec=codec)


def in_trace(x: Any) -> bool:
    """True while ``x`` is being traced rather than computed: inside
    ``torch.compile``'s tracing, or on a CUDA stream that is being captured
    into a graph (the JAX package's ``isinstance(x, jax.core.Tracer)``)."""
    if torch.compiler.is_compiling():
        return True
    return isinstance(x, Tensor) and x.is_cuda and torch.cuda.is_current_stream_capturing()


def sync_state_host(
    state: Dict[str, Any],
    reductions: Dict[str, Any],
    gather_fn: Optional[Callable] = None,
    distributed_available_fn: Optional[Callable] = None,
    *,
    transport: Optional[Any] = None,
    config: Optional[Any] = None,
    site: str = "sync_state_host",
) -> Dict[str, Any]:
    """Host-level all-reduce of a functional state pytree across processes.

    The serving engine's analogue of ``Metric._sync_dist``: the engine holds
    state as explicit pytrees (never inside a ``Metric`` instance), so its
    ``compute(key, sync=True)`` syncs here. Single-process is the identity.

    Two routes, both through :mod:`metrics_tpu_torch.comm.plane`:

    - ``gather_fn`` injected → the leaf-at-a-time reference protocol
      (:func:`~metrics_tpu_torch.comm.plane.sync_with_gather_fn`); no codecs —
      an injected gather returns decoded peer tensors.
    - otherwise → the planned path (:func:`~metrics_tpu_torch.comm.plane.sync_pytree`):
      cached plan, policy codecs, coalesced collectives, retry/degradation
      ladder. ``transport``/``config`` override the process-wide
      ``comm.configure`` state.

    ``_update_count`` always sums (each process counted its own updates) —
    exactly once, even when a caller also lists it in ``reductions``.
    """
    from metrics_tpu_torch.utils.distributed import distributed_available

    if gather_fn is not None:
        if not (distributed_available_fn or distributed_available)():
            return state
        if _OBS.enabled:
            _obs.record_sync_bytes(site, "state_pytree", _obs.tree_nbytes(state))
        return _plane.sync_with_gather_fn(state, reductions, gather_fn, site=site)

    cfg = config or _plane.get_config()
    tr = transport or cfg.transport
    if tr is None:
        if not (distributed_available_fn or distributed_available)():
            return state
        tr = _plane.default_transport()
    if _OBS.enabled:
        _obs.record_sync_bytes(site, "state_pytree", _obs.tree_nbytes(state))
    return _plane.sync_pytree(state, reductions, transport=tr, config=cfg, site=site)
