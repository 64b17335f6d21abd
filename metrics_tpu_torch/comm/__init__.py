"""metrics_tpu_torch.comm — compressed, fault-tolerant state sync
(port of ``metrics_tpu/comm``).

The single chokepoint for all state synchronisation in the port::

    from metrics_tpu_torch import comm

    # opt large float cat-states into blockwise int8 on the wire
    comm.configure(policy=comm.CodecPolicy(lossy="int8"))
    # give multi-process gathers a deadline + retry budget
    comm.configure(timeout_s=30.0, max_retries=3)

    engine.compute(k, sync=True)  # the engine's host sync rides the plane
    comm.last_report()            # what it cost / whether it degraded

Three layers:

- :mod:`~metrics_tpu_torch.comm.codec` — how a leaf looks on the wire
  (lossless / fp16 / blockwise int8), chosen per state by a dtype- and
  reduction-aware :class:`CodecPolicy`; the snapshot format
  (:mod:`metrics_tpu_torch.ckpt.format`) rides it too;
- :mod:`~metrics_tpu_torch.comm.plan` — signature-cached transfer plans:
  coalesce small fixed-shape leaves into one buffer per dtype, chunk big ones,
  route ragged ``cat`` states through the pad-to-max (or exact-broadcast)
  protocol;
- :mod:`~metrics_tpu_torch.comm.transport` — who moves the buffers
  (``torch.distributed`` over gloo, an in-process :class:`LoopbackWorld`, or
  injected fakes) and the failure vocabulary the retry → degradation ladder in
  :mod:`~metrics_tpu_torch.comm.plane` consumes.

Plus the membership layer (:mod:`~metrics_tpu_torch.comm.membership`): a
per-process :class:`WorldView` fed by attributed collective failures and a
two-phase live-set agreement, which give the ladder its ``live_subset`` rung.
The device path, :func:`reduce_in_trace` (``Metric.sync_state``,
``compute_from(axis_name=...)``), issues ``torch.distributed`` collectives on
the states' own device.
"""

from metrics_tpu_torch.comm.codec import (
    Codec,
    CodecPolicy,
    EncodedLeaf,
    Fp16Codec,
    Int8BlockCodec,
    LosslessCodec,
    get_codec,
    register_codec,
)
from metrics_tpu_torch.comm.membership import MembershipError, WorldView, agree_live_set, view_for
from metrics_tpu_torch.comm.plan import TransferPlan, build_plan, clear_plan_cache, plan_cache_info
from metrics_tpu_torch.comm.plane import (
    CommConfig,
    SyncReport,
    configure,
    default_transport,
    get_config,
    last_report,
    reduce_in_trace,
    sync_pytree,
    sync_pytree_in_trace,
    sync_state,
    sync_with_gather_fn,
    use_config,
)
from metrics_tpu_torch.comm.transport import (
    DeadPeerTransport,
    FlakyTransport,
    LocalTransport,
    LoopbackWorld,
    MultihostTransport,
    PeerLostError,
    ReplicaFakeTransport,
    ScriptedFakeTransport,
    StallTransport,
    Transport,
    TransportError,
    TransportTimeout,
    gather_ragged,
)

__all__ = [
    "Codec",
    "CodecPolicy",
    "CommConfig",
    "DeadPeerTransport",
    "EncodedLeaf",
    "FlakyTransport",
    "Fp16Codec",
    "Int8BlockCodec",
    "LocalTransport",
    "LoopbackWorld",
    "LosslessCodec",
    "MembershipError",
    "MultihostTransport",
    "PeerLostError",
    "ReplicaFakeTransport",
    "ScriptedFakeTransport",
    "StallTransport",
    "SyncReport",
    "TransferPlan",
    "Transport",
    "TransportError",
    "TransportTimeout",
    "WorldView",
    "agree_live_set",
    "build_plan",
    "clear_plan_cache",
    "configure",
    "default_transport",
    "gather_ragged",
    "get_codec",
    "get_config",
    "last_report",
    "plan_cache_info",
    "reduce_in_trace",
    "register_codec",
    "sync_pytree",
    "sync_pytree_in_trace",
    "sync_state",
    "sync_with_gather_fn",
    "use_config",
    "view_for",
]
