"""Transfer planner: from a state pytree to the minimal sequence of collectives
(port of ``metrics_tpu/comm/plan.py``).

Planning happens once per abstract state signature (shape/dtype skeleton —
shapes and dtypes of the leaves, whatever device holds them) and is cached; execution happens
every sync. The plan decides, per leaf:

- **route** — fixed-shape array leaves (``sum``/``mean``/``max``/``min``, the
  ``_update_count`` special case, AND callable ``dist_reduce_fx`` — e.g. the
  sketch plane's top-k ledger merge) have identical shapes on every rank by
  construction, so they *coalesce*: all their encoded payloads of one wire
  dtype become a single flat buffer → one collective instead of N. ``cat``/
  ``None``/list leaves are potentially ragged across ranks and go through
  :func:`~metrics_tpu_torch.comm.transport.gather_ragged` individually.
- **codec** — asked of the :class:`~metrics_tpu_torch.comm.codec.CodecPolicy` with
  the leaf's name, reduction, dtype and byte size.
- **chunking** — coalesced buffers larger than ``chunk_bytes`` split into
  bounded slices so one giant leaf can't turn the sync into a single
  monolithic transfer (and so per-chunk retry stays cheap).

The planner sees only shapes; offsets into coalesced buffers come from each
codec's ``payload_specs`` so execution never re-derives layout.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.comm.codec import CodecPolicy, get_codec

__all__ = ["LeafPlan", "TransferPlan", "build_plan", "plan_cache_info", "clear_plan_cache"]

_REDUCIBLE = ("sum", "mean", "max", "min")


def np_dtype(dtype: Any) -> np.dtype:
    """The numpy dtype of a torch or numpy dtype (``torch.int32`` → ``int32``).

    ``bfloat16`` has no numpy dtype of its own; it maps to ``ml_dtypes``'s,
    imported only then, as the JAX package's arrays carry it.
    """
    if not isinstance(dtype, torch.dtype):
        return np.dtype(dtype)
    if dtype == torch.bfloat16:
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return torch.empty((), dtype=dtype).numpy().dtype


def host_array(x: Any) -> np.ndarray:
    """``x`` as a numpy array on the host: a tensor (on any device) is copied
    to the host — a CPU tensor too, so no transport ever aliases a live state
    — and anything else goes through ``np.asarray``. This is where the host
    path stages a state that lives on the card, as the JAX package's stages
    through ``multihost_utils``."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).to("cpu", copy=True).numpy().view(np_dtype(torch.bfloat16))
        return x.to("cpu", copy=True).numpy()
    return np.asarray(x)


def device_tensor(x: Any, device: torch.device) -> torch.Tensor:
    """``x`` (a numpy array or a tensor) as a tensor on ``device``: the inverse
    of :func:`host_array` for a synced leaf going back where it lived."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.asarray(x)
    if not (x.flags.c_contiguous and x.flags.writeable):
        x = np.array(x, order="C")  # (np.ascontiguousarray would make a 0-d array 1-d)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(x).to(device)


@dataclass(frozen=True)
class _PayloadSlot:
    """Where one encoded payload of one leaf lives inside a coalesced buffer."""

    leaf: str
    payload_idx: int
    offset: int  # elements into the flat buffer
    size: int  # elements
    shape: Tuple[int, ...]


@dataclass(frozen=True)
class LeafPlan:
    name: str
    route: str  # "coalesce" | "ragged" | "skip"
    codec_name: str
    reduction_tag: str  # str reductions verbatim; "callable"; "none"
    is_list: bool
    shape: Tuple[int, ...]
    dtype: str


@dataclass(frozen=True)
class _CoalescedBuffer:
    """One flat wire buffer: every coalesced payload sharing (wire dtype, op).

    Keying on the reduction op too lets execution reduce the WHOLE gathered
    buffer with a single torch op and slice leaves out afterwards (``fast``,
    all-lossless buffers) instead of paying a device copy + stack + reduce per
    leaf — bit-identical, since axis-0 reductions are independent per element.
    """

    dtype: str
    op: str  # sum | mean | max | min
    total: int  # elements
    slots: Tuple[_PayloadSlot, ...]
    chunks: Tuple[Tuple[int, int], ...]  # (start, stop) element ranges
    fast: bool  # every slot lossless → buffer-level reduce + slice


@dataclass(frozen=True)
class TransferPlan:
    signature: str
    leaves: Tuple[LeafPlan, ...]
    buffers: Tuple[_CoalescedBuffer, ...]
    has_update_count_extra: bool  # trailing _update_count outside `reductions`

    @property
    def collective_count(self) -> int:
        """Collectives a fault-free execution issues (ragged leaves may add
        shape-gather rounds on top)."""
        return sum(len(b.chunks) for b in self.buffers) + sum(
            len(get_codec(lf.codec_name).payload_specs(lf.shape, np.dtype(lf.dtype)))
            for lf in self.leaves
            if lf.route == "ragged"
        )


def _leaf_meta(val: Any) -> Tuple[Tuple[int, ...], np.dtype, int]:
    if getattr(val, "dtype", None) is None or getattr(val, "shape", None) is None:
        val = np.asarray(val)  # plain Python scalars (e.g. an int _update_count)
    shape = tuple(int(d) for d in val.shape)
    dtype = np_dtype(val.dtype)
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize if shape else dtype.itemsize
    return shape, dtype, nbytes


def _reduction_tag(reduction: Any) -> str:
    if reduction is None:
        return "none"
    if isinstance(reduction, str):
        return reduction
    return "callable"


def _signature(state: Dict[str, Any], reductions: Dict[str, Any]) -> str:
    """Abstract identity of (state skeleton, reduction routing) for the cache key."""
    parts: List[str] = []
    for name in sorted(reductions, key=str):
        val = state.get(name)
        if isinstance(val, list):
            if not val:
                parts.append(f"{name}:[]")
                continue
            shapes = ";".join(
                f"{np_dtype(getattr(v, 'dtype', np.float32))}[{'x'.join(map(str, getattr(v, 'shape', ())))}]"
                for v in val
            )
            parts.append(f"{name}:[{shapes}]:{_reduction_tag(reductions[name])}")
        else:
            shape, dtype, _ = _leaf_meta(val)
            parts.append(f"{name}:{dtype}[{'x'.join(map(str, shape))}]:{_reduction_tag(reductions[name])}")
    if "_update_count" in state and "_update_count" not in reductions:
        shape, dtype, _ = _leaf_meta(state["_update_count"])
        parts.append(f"_update_count:{dtype}[{'x'.join(map(str, shape))}]:sum")
    return "|".join(parts)


_PLAN_CACHE: Dict[Tuple[str, CodecPolicy, int, bool, Any], TransferPlan] = {}
_PLAN_LOCK = threading.Lock()
_PLAN_CACHE_MAX = 256
_cache_hits = 0
_cache_misses = 0


def plan_cache_info() -> Dict[str, int]:
    with _PLAN_LOCK:
        return {"size": len(_PLAN_CACHE), "hits": _cache_hits, "misses": _cache_misses}


def clear_plan_cache() -> None:
    global _cache_hits, _cache_misses
    with _PLAN_LOCK:
        _PLAN_CACHE.clear()
        _cache_hits = 0
        _cache_misses = 0


def build_plan(
    state: Dict[str, Any],
    reductions: Dict[str, Any],
    policy: CodecPolicy,
    *,
    chunk_bytes: int = 4 << 20,
    coalesce: bool = True,
    world: Optional[int] = None,
) -> TransferPlan:
    """Plan (cached on the state's abstract signature) the transfers for one sync.

    ``world`` joins the cache key so sub-world plans (the ``live_subset``
    ladder rung executing over an agreed surviving subset) cache exactly like
    full-world plans — the layout itself is world-agnostic (execution sizes
    gathers off ``transport.world_size()``), so each distinct world size costs
    one cache entry, never a rebuild per sync.
    """
    global _cache_hits, _cache_misses
    sig = _signature(state, reductions)
    key = (sig, policy, int(chunk_bytes), bool(coalesce), None if world is None else int(world))
    with _PLAN_LOCK:
        plan = _PLAN_CACHE.get(key)
        if plan is not None:
            _cache_hits += 1
            return plan
        _cache_misses += 1

    leaves: List[LeafPlan] = []
    # dict order of `reductions` is the deterministic leaf order — the same
    # order every retry re-executes, so reductions are reproducible mid-ladder
    items: List[Tuple[str, Any]] = list(reductions.items())
    extra_count = "_update_count" in state and "_update_count" not in reductions
    if extra_count:
        items.append(("_update_count", "sum"))
    for name, reduction in items:
        val = state[name]
        is_list = isinstance(val, list)
        if is_list:
            if not val:
                leaves.append(LeafPlan(name, "skip", "lossless", _reduction_tag(reduction), True, (), "float32"))
                continue
            # planning sees the leaf post-normalisation (dim_zero_cat of the list)
            shapes = [tuple(int(d) for d in getattr(v, "shape", ())) for v in val]
            lead = sum(s[0] if s else 1 for s in shapes)
            rest = shapes[0][1:] if shapes[0] else ()
            shape = (lead, *rest)
            dtype = np_dtype(getattr(val[0], "dtype", np.float32))
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        else:
            shape, dtype, nbytes = _leaf_meta(val)
        tag = _reduction_tag(reduction)
        codec_name = policy.choose(name, reduction, dtype, nbytes)
        # callable reductions on ARRAY leaves are fixed-shape by the same
        # argument as the string ops (every rank registered the same default):
        # they ride the coalesced flat-buffer gather and reduce per leaf after
        # slicing (never the buffer-level fast reduce — see below). Only
        # list/cat/None leaves are potentially ragged across ranks.
        fixed_shape = (tag in _REDUCIBLE or tag == "callable") and not is_list
        route = "coalesce" if (fixed_shape and coalesce) else ("ragged" if not fixed_shape else "solo")
        # "solo" (coalescing off) still uses the fixed-shape direct path, as a
        # one-leaf coalesced buffer — keeps execution single-pathed
        leaves.append(LeafPlan(name, "coalesce" if route == "solo" else route, codec_name, tag, is_list, shape, str(dtype)))

    # lay out coalesced buffers: one per (wire dtype, reduction op), in leaf
    # order; with coalescing off, every leaf-payload becomes its own
    # single-slot buffer (offset 0)
    buffers: List[_CoalescedBuffer] = []
    by_key: Dict[Tuple[str, str], List[Tuple[_PayloadSlot, bool]]] = {}
    offsets: Dict[Tuple[str, str], int] = {}
    for lf in leaves:
        if lf.route != "coalesce":
            continue
        codec = get_codec(lf.codec_name)
        for idx, (pshape, pdtype) in enumerate(codec.payload_specs(lf.shape, np.dtype(lf.dtype))):
            d = str(pdtype)
            size = int(np.prod(pshape, dtype=np.int64)) if pshape else 1
            group = (d, lf.reduction_tag)
            if coalesce:
                off = offsets.get(group, 0)
                by_key.setdefault(group, []).append(
                    (_PayloadSlot(lf.name, idx, off, size, tuple(pshape)), codec.lossless)
                )
                offsets[group] = off + size
            else:
                chunk_elems = max(1, int(chunk_bytes) // max(1, np.dtype(d).itemsize))
                slot = _PayloadSlot(lf.name, idx, 0, size, tuple(pshape))
                chunks = tuple((s, min(s + chunk_elems, size)) for s in range(0, size, chunk_elems)) or ((0, 0),)
                buffers.append(
                    _CoalescedBuffer(
                        d,
                        lf.reduction_tag,
                        size,
                        (slot,),
                        chunks,
                        codec.lossless and lf.reduction_tag in _REDUCIBLE,
                    )
                )
    for (d, op), slot_pairs in by_key.items():
        total = offsets[(d, op)]
        chunk_elems = max(1, int(chunk_bytes) // max(1, np.dtype(d).itemsize))
        chunks = tuple((s, min(s + chunk_elems, total)) for s in range(0, total, chunk_elems)) or ((0, 0),)
        buffers.append(
            _CoalescedBuffer(
                d,
                op,
                total,
                tuple(s for s, _ in slot_pairs),
                chunks,
                # buffer-level single-op reduce only exists for the elementwise
                # string ops; a "callable" buffer gathers coalesced but reduces
                # per leaf (the callable sees rank-stacked leaf rows)
                all(l for _, l in slot_pairs) and op in _REDUCIBLE,
            )
        )

    plan = TransferPlan(sig, tuple(leaves), tuple(buffers), extra_count)
    with _PLAN_LOCK:
        if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
        _PLAN_CACHE[key] = plan
    return plan
