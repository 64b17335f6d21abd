"""Multi-tenant keyed state (port of ``metrics_tpu/engine/stream.py``).

Two regimes, one interface (``slot_for`` / ``state_of`` / ``rotate`` / ``merged_state``):

- :class:`KeyedState` — the fused regime. Every tenant's state tree is stacked along
  a leading key axis, so one micro-batch updates all tenants through the masked scan
  (:mod:`metrics_tpu_torch.kernels.engine_scan`), captured on the card as one CUDA
  graph. Capacity grows by doubling (each growth changes the stacked shape, i.e.
  costs one capture set — bounded log₂(K)).
- :class:`EagerKeyedState` — the host regime for metrics the fused path cannot serve
  (ragged "cat" list states, host-compute metrics): a plain dict of per-key states
  updated eagerly. Same tenancy and windowing semantics, more launches.

A captured graph is bound to the addresses of the slab it was captured on. So the
slab's tensors are written in place (``copy_``) by ``set_state``, ``evict``,
``rotate``, ``reset`` and ``restore`` (a snapshot's slab), and only
:meth:`KeyedState.ensure_capacity` makes new tensors (capacity is part of the
graph cache key). Reads (``state_of``,
``merged_state``) return copies, never views of the slab, since later dispatches
write into it.

Sliding windows ride on the pure ``merge_states`` API: ``rotate()`` snapshots the
current segment into a ring (maxlen = window - 1) and resets the live segment;
``merged_state(key)`` folds the surviving ring segments into the live one.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, Hashable, List, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from metrics_tpu_torch.kernels.engine_scan import leaves_like
from metrics_tpu_torch.metric import _as_state_tensor
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError


def _validate_window(window: Optional[int]) -> Optional[int]:
    if window is None:
        return None
    window = int(window)
    if window < 1:
        raise MetricsTPUUserError(f"`window` must be >= 1 segment, got {window}")
    return window


def _clone_tree(tree: Any) -> Any:
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


class KeyedState:
    """Stacked per-key state for the fused dispatch path."""

    def __init__(self, metric: Any, capacity: int = 8, window: Optional[int] = None) -> None:
        self._metric = metric
        init_leaves, self._treedef = tree_flatten(metric.init_state())
        # tensor leaves on the metric's device, dtypes as init_state gives them
        # (int32 counts stay int32; the captured graphs read these dtypes)
        self._init_leaves: List[torch.Tensor] = [torch.as_tensor(leaf) for leaf in init_leaves]
        self.last_resize_s = 0.0  # wall time of the most recent capacity growth
        self.capacity = 1
        while self.capacity < max(1, int(capacity)):
            self.capacity *= 2
        self.stacked = tree_unflatten(self._tiled(self.capacity), self._treedef)
        self._slots: Dict[Hashable, int] = {}
        self._max_slot = -1  # highest installed id (ids can be gapped — see slot_for)
        # retired slot ids eligible for reuse by NEW tenants (release_slot)
        self._free_slots: List[int] = []
        self._free_set: set = set()
        # covers only the id handout: submit threads allocate while the dispatcher
        # reads the watermark
        self._alloc_lock = threading.Lock()
        self.rotations = 0  # total rotate() calls
        self.window = _validate_window(window)
        # ring entries are (capacity_at_snapshot, stacked_snapshot): a key allocated
        # after a snapshot was taken simply has no contribution in that segment
        self._ring: Optional[Deque[Tuple[int, Any]]] = (
            deque(maxlen=self.window - 1) if self.window and self.window > 1 else None
        )

    # ------------------------------------------------------------------ slots

    def _tiled(self, k: int) -> List[torch.Tensor]:
        return [init.expand((k,) + init.shape).clone() for init in self._init_leaves]

    def leaves(self) -> List[torch.Tensor]:
        """The slab's tensors, in the state tree's flattened order."""
        return tree_flatten(self.stacked)[0]

    @property
    def keys(self) -> Tuple[Hashable, ...]:
        return tuple(self._slots)

    def slot_for(self, key: Hashable) -> int:
        """Slot index for ``key``, allocating the next FREE one on first sight.

        The slot may temporarily exceed ``capacity`` until the dispatcher calls
        ``ensure_capacity``. Retired slots (``release_slot``) are reused first.
        Fresh allocation is ``max(installed ids) + 1``, not ``len(slots)``:
        :meth:`install_slot` can install ids with gaps, and a length-based
        allocator would hand a new tenant an id inside such a gap's occupied tail.
        """
        slot = self._slots.get(key)
        if slot is None:
            with self._alloc_lock:
                slot = self._slots.get(key)
                if slot is None:
                    if self._free_slots:
                        slot = self._free_slots.pop()
                        self._free_set.discard(slot)
                    else:
                        slot = self._max_slot + 1
                        self._max_slot = slot
                    self._slots[key] = slot
        return slot

    def install_slot(self, key: Hashable, slot: int) -> int:
        """Install an externally assigned slot id for ``key`` (a ``setdefault``),
        keeping the max-id watermark that :meth:`slot_for` allocates above in
        sync. Returns the effective id (the existing one if ``key`` was already
        installed)."""
        with self._alloc_lock:
            existing = self._slots.setdefault(key, int(slot))
            self._max_slot = max(self._max_slot, existing)
            if existing in self._free_set:
                self._free_set.discard(existing)
                self._free_slots.remove(existing)
        return existing

    def ensure_capacity(self, min_slots: Optional[int] = None) -> bool:
        """Grow the key axis (doubling) to fit every allocated slot. True if grown.

        The needed capacity is ``max id + 1``, not ``len(slots)`` (ids can be
        gapped, see :meth:`slot_for`); ``min_slots`` raises the floor further.
        The only method that makes new slab tensors: graphs captured on the old
        ones are keyed by the old capacity and never replayed again.
        """
        need = max(self._max_slot + 1, int(min_slots) if min_slots is not None else 0)
        if need <= self.capacity:
            return False
        new_cap = self.capacity
        while new_cap < need:
            new_cap *= 2
        t0 = time.perf_counter()
        pad_rows = new_cap - self.capacity
        grown = [
            torch.cat([leaf, init.expand((pad_rows,) + init.shape)], dim=0)
            for leaf, init in zip(self.leaves(), self._init_leaves)
        ]
        self.stacked = tree_unflatten(grown, self._treedef)
        if grown and grown[0].is_cuda:
            # an honest wall-time figure for the resize counter; growth happens
            # log₂(K) times per tenant population. The stream that grew the slab
            # is synchronized, not the device: a device-wide sync would break
            # another engine's capture in progress on the same card
            torch.cuda.current_stream(grown[0].device).synchronize()
        self.capacity = new_cap
        self.last_resize_s = time.perf_counter() - t0
        return True

    def restore(self, capacity: int, leaves: Sequence[Any], slots: Dict[Hashable, int],
                ring: Sequence[Tuple[int, Sequence[Any]]] = (), rotations: int = 0) -> None:
        """Install a snapshot: its slab (``leaves``, each ``(capacity, *shape)``,
        in the state tree's flattened order), slot map, window ring and rotation
        count.

        The live slab first grows to the snapshot's capacity (the only new
        tensors, as in any growth); the snapshot's rows are then copied into it
        in place and the rows beyond them scrubbed to init, so graphs captured on
        the live slab stay valid. The slot ids are installed as they were, gaps
        included, and the allocation watermark sits above the highest: a new
        tenant never lands on an existing tenant's row.
        """
        capacity = int(capacity)
        self.ensure_capacity(min_slots=capacity)
        for leaf, new, init in zip(self.leaves(), leaves, self._init_leaves):
            leaf[:capacity].copy_(_as_state_tensor(new, leaf.device))
            leaf[capacity:].copy_(init.expand_as(leaf[capacity:]))
        with self._alloc_lock:
            self._slots = {key: int(slot) for key, slot in slots.items()}
            self._max_slot = max(self._slots.values(), default=-1)
            self._free_slots = []
            self._free_set = set()
        if self._ring is not None:
            self._ring.clear()
            device = self._init_leaves[0].device if self._init_leaves else None
            for cap, seg in ring:
                self._ring.append(
                    (int(cap), tree_unflatten([_as_state_tensor(x, device) for x in seg], self._treedef))
                )
        self.rotations = int(rotations)

    # ------------------------------------------------------------------ reads

    def state_of(self, key: Hashable) -> Any:
        """Per-key live-segment state: a copy (a fresh init state for a key that
        was allocated but never dispatched into the stacked slab)."""
        slot = self._slots[key]
        if slot >= self.capacity:
            return self._metric.init_state()
        return tree_unflatten([leaf[slot].clone() for leaf in self.leaves()], self._treedef)

    def set_state(self, key: Hashable, state: Any) -> None:
        """Write one key's state into its row of the slab, in place."""
        self.ensure_capacity()
        slot = self._slots[key]
        for leaf, new in zip(self.leaves(), leaves_like(state, self._treedef)):
            leaf[slot].copy_(torch.as_tensor(new))

    def commit(self, stacked: Any) -> None:
        """Copy a whole slab of the same shapes into this one, in place."""
        for leaf, new in zip(self.leaves(), leaves_like(stacked, self._treedef)):
            leaf.copy_(new)

    def _scrub(self, leaves: List[torch.Tensor], slot: int) -> None:
        for leaf, init in zip(leaves, self._init_leaves):
            leaf[slot].copy_(init)

    def evict(self, key: Hashable) -> Optional[int]:
        """Drop a tenant's tenancy: forget its slot, scrub its live row to init.

        Returns the freed slot id (or ``None`` if the key was unknown). The id is
        not reusable until it is handed to :meth:`release_slot`. Ring segments are
        not scrubbed here: ring reads are slot-addressed through ``_slots``, so a
        popped key's old rows are unreachable until the slot is reused —
        :meth:`release_slot` scrubs them first.
        """
        slot = self._slots.pop(key, None)
        if slot is None:
            return None
        if slot < self.capacity:
            self._scrub(self.leaves(), slot)
        return slot

    def release_slot(self, slot: Optional[int]) -> None:
        """Return a retired slot id to the free-list for reuse by NEW tenants,
        scrubbing its window ring rows to init first (merged reads are
        slot-addressed, so a new tenant must not inherit old contributions)."""
        if slot is None:
            return
        slot = int(slot)
        with self._alloc_lock:
            if slot in self._free_set:
                return
            self._free_slots.append(slot)
            self._free_set.add(slot)
        if self._ring:
            for cap, snap in self._ring:
                if slot < cap:
                    self._scrub(tree_flatten(snap)[0], slot)

    def _scrub_rows(self, leaves: List[torch.Tensor], slots: List[int]) -> None:
        """Rows ``slots`` (distinct) of every leaf back to init: one
        ``index_copy_`` per leaf."""
        if not slots or not leaves:
            return
        idx = torch.tensor(slots, dtype=torch.int64).to(leaves[0].device)
        for leaf, init in zip(leaves, self._init_leaves):
            leaf.index_copy_(0, idx, init.expand((len(slots),) + init.shape))

    def evict_many(self, keys: Sequence[Hashable]) -> List[Optional[int]]:
        """:meth:`evict` for many tenants, the live rows scrubbed in one pass per
        leaf. Returns the freed slot ids in the order of ``keys``."""
        slots = [self._slots.pop(key, None) for key in keys]
        self._scrub_rows(self.leaves(), [s for s in slots if s is not None and s < self.capacity])
        return slots

    def release_slots(self, slots: Sequence[Optional[int]]) -> None:
        """:meth:`release_slot` for many ids, in order (the free-list ends as
        the same calls one at a time would leave it), each ring segment
        scrubbed in one pass per leaf."""
        fresh: List[int] = []
        with self._alloc_lock:
            for slot in slots:
                if slot is None or int(slot) in self._free_set:
                    continue
                slot = int(slot)
                self._free_slots.append(slot)
                self._free_set.add(slot)
                fresh.append(slot)
        for cap, snap in self._ring or ():
            self._scrub_rows(tree_flatten(snap)[0], [s for s in fresh if s < cap])

    # ------------------------------------------------------------------ windowing

    def _reset_live(self) -> None:
        for leaf, init in zip(self.leaves(), self._init_leaves):
            leaf.copy_(init.expand_as(leaf))

    def rotate(self) -> None:
        """Close the live segment: snapshot it into the ring, reset the live slab
        in place.

        With ``window=1`` there is no ring — rotation is a plain reset. The ring's
        maxlen evicts the oldest segment once ``window`` segments exist.
        """
        if self.window is None:
            raise MetricsTPUUserError("rotate() requires the engine/state to be built with `window=`")
        if self._ring is not None:
            self._ring.append((self.capacity, _clone_tree(self.stacked)))
        self._reset_live()
        self.rotations += 1

    def merged_state(self, key: Hashable) -> Any:
        """Window view: ring segments merged (oldest first) into the live segment."""
        state = self.state_of(key)
        if not self._ring:
            return state
        slot = self._slots[key]
        merged = None
        for cap, snap in self._ring:
            if slot >= cap:
                continue  # key didn't exist in this segment
            seg = tree_map(lambda x: x[slot].clone(), snap)
            merged = seg if merged is None else self._metric.merge_states(merged, seg)
        return state if merged is None else self._metric.merge_states(merged, state)

    def reset(self) -> None:
        self._reset_live()
        if self._ring is not None:
            self._ring.clear()


class EagerKeyedState:
    """Per-key states for metrics the fused path cannot serve."""

    def __init__(self, metric: Any, window: Optional[int] = None) -> None:
        self._metric = metric
        self.last_resize_s = 0.0  # interface parity with KeyedState (never grows)
        self.rotations = 0
        self._states: Dict[Hashable, Any] = {}
        self.window = _validate_window(window)
        self._ring: Optional[Deque[Dict[Hashable, Any]]] = (
            deque(maxlen=self.window - 1) if self.window and self.window > 1 else None
        )

    @property
    def keys(self) -> Tuple[Hashable, ...]:
        return tuple(self._states)

    def slot_for(self, key: Hashable) -> None:
        self._states.setdefault(key, self._metric.init_state())
        return None

    def ensure_capacity(self, min_slots: Optional[int] = None) -> bool:
        return False

    def state_of(self, key: Hashable) -> Any:
        return self._states[key]

    def set_state(self, key: Hashable, state: Any) -> None:
        self._states[key] = state

    def evict(self, key: Hashable) -> Optional[int]:
        """Drop a tenant everywhere. Eager ring segments are KEY-addressed, so the
        ring is scrubbed too: a re-registered key must not resurrect old window
        contributions."""
        self._states.pop(key, None)
        if self._ring is not None:
            for seg in self._ring:
                seg.pop(key, None)
        return None

    def release_slot(self, slot: Optional[int]) -> None:
        """Interface parity with KeyedState — eager states have no slots."""

    def update(self, key: Hashable, *args: Any) -> None:
        self._states[key] = self._metric.update_state(
            self._states.setdefault(key, self._metric.init_state()), *args
        )

    def rotate(self) -> None:
        if self.window is None:
            raise MetricsTPUUserError("rotate() requires the engine/state to be built with `window=`")
        if self._ring is not None:
            self._ring.append(self._states)
        self._states = {k: self._metric.init_state() for k in self._states}
        self.rotations += 1

    def merged_state(self, key: Hashable) -> Any:
        state = self.state_of(key)
        if not self._ring:
            return state
        merged = None
        for snap in self._ring:
            if key not in snap:
                continue
            merged = snap[key] if merged is None else self._metric.merge_states(merged, snap[key])
        return state if merged is None else self._metric.merge_states(merged, state)

    def reset(self) -> None:
        self._states = {k: self._metric.init_state() for k in self._states}
        if self._ring is not None:
            self._ring.clear()
