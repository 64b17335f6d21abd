"""Residency manager: which tenants live where, and who gets demoted next
(port of ``metrics_tpu/tier/residency.py``).

Mechanics and policy for the three-tier slab. A non-resident tenant is one
*entry* — ``{"state": host tree | None, "ring": [row | None, ...], "rot": N}``
— captured from the stacked slab at demotion time, with numpy leaves (the
JAX package's entries, so spill files, promote records and exported entries
read in both packages). ``rot`` is the engine's rotation counter when the
entry was captured: window ring segments age out by rotation, so readmission
(and host-side peeks) place each captured row at its *absolute* segment index
rather than positionally, which is what makes a demote→readmit round trip
bit-identical to a never-demoted twin even when rotations happened in between.

On the card the live slab's tensors are the inputs and outputs of the
engine's captured CUDA graphs, so readmission writes an entry into the
tenant's row of the existing slab in place (``copy_`` on the caller's current
stream, which the engine sets to its own). The host source of every
host-to-device copy is pageable memory copied without ``non_blocking``: the
copy has finished when ``copy_`` returns, so Python may free the entry at
once. Window ring segments are clones that no graph reads, so a segment that
predates a slot is grown by concatenation, as the JAX package does.

Demotion reads rows off the card: :func:`capture_entry` copies one tenant
(one device-to-host copy per leaf), :func:`capture_entries` many at once (one
``index_select`` and one device-to-host copy per leaf for all of them), and
gives the same entries.

The manager itself holds no locks: every mutating call happens on the
engine's dispatcher thread or under the engine's dispatch lock (the same
discipline the slab itself uses). Idleness is a per-tenant last-active stamp:
``touch`` records the clock, seconds since the stamp (saturating at
``idle_demote_s``) is the coldness ordering, and a tenant with no stamp counts
as fully idle.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from metrics_tpu_torch.ckpt.restore import host_tree
from metrics_tpu_torch.engine.stream import KeyedState
from metrics_tpu_torch.kernels.engine_scan import leaves_like
from metrics_tpu_torch.metric import _as_state_tensor
from metrics_tpu_torch.tier.coldstore import ColdStore
from metrics_tpu_torch.tier.config import TierConfig

HOT = "hot"
WARM = "warm"
COLD = "cold"


# --------------------------------------------------------------------- mechanics


def _ordered_like(tree: Any, like: Any) -> Any:
    """``tree`` rebuilt with ``like``'s dict key order (entries written by the
    JAX package hold dicts with sorted keys); leaves are kept as they are."""
    if isinstance(like, dict) and isinstance(tree, dict):
        return {k: _ordered_like(tree[k], like[k]) for k in like}
    if isinstance(like, (list, tuple)) and isinstance(tree, (list, tuple)):
        return type(tree)(_ordered_like(t, l) for t, l in zip(tree, like))
    return tree


def _like(keyed: KeyedState) -> Any:
    """The slab's state layout, built from its init leaves (no allocation)."""
    return tree_unflatten(keyed._init_leaves, keyed._treedef)


def _device_of(keyed: Any) -> torch.device:
    if isinstance(keyed, KeyedState) and keyed._init_leaves:
        return keyed._init_leaves[0].device
    leaves = [x for x in tree_flatten(keyed._metric.init_state())[0] if isinstance(x, torch.Tensor)]
    return leaves[0].device if leaves else torch.device("cpu")


def _on_device(tree: Any, device: torch.device) -> Any:
    """An entry's host tree as tensors on ``device`` (containers rebuilt)."""
    if isinstance(tree, (np.ndarray, np.generic)):
        return _as_state_tensor(tree, device)
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_device(v, device) for v in tree)
    return tree


def capture_entry(keyed: Any, key: Hashable) -> Dict[str, Any]:
    """One tenant's full state as a host entry (live + ring rows + rotation stamp).

    Does not mutate the slab — the caller evicts separately so the capture /
    journal / evict order stays explicit at the call site.
    """
    state = keyed.state_of(key)
    ring_rows: List[Any] = []
    if isinstance(keyed, KeyedState):
        slot = keyed._slots[key]
        if keyed._ring is not None:
            for cap, snap in keyed._ring:
                ring_rows.append(None if slot >= cap else tree_map(lambda x: x[slot], snap))
    elif keyed._ring is not None:
        for seg in keyed._ring:
            ring_rows.append(seg.get(key))
    entry = host_tree({"state": state, "ring": ring_rows})
    entry["rot"] = int(keyed.rotations)
    return entry


def _gather_rows(leaves: List[torch.Tensor], slots: List[int]) -> List[np.ndarray]:
    """Rows ``slots`` of each leaf on the host: one ``index_select`` and one
    device-to-host copy per leaf."""
    idx = torch.tensor(slots, dtype=torch.int64).to(leaves[0].device) if leaves else None
    return [leaf.index_select(0, idx).cpu().numpy() for leaf in leaves]


def _split_rows(host: List[np.ndarray], treedef: Any, i: int) -> Any:
    # np.array copies: each entry owns its leaves, 0-d rows stay 0-d arrays
    return tree_unflatten([np.array(h[i]) for h in host], treedef)


def capture_entries(keyed: Any, keys: Sequence[Hashable]) -> List[Dict[str, Any]]:
    """:func:`capture_entry` for many tenants at once, the same entries in the
    order of ``keys``. On a stacked slab every leaf of the live segment (and
    of each ring segment) is gathered for all the tenants in one
    ``index_select`` and copied to the host once, instead of once per tenant."""
    keys = list(keys)
    if not isinstance(keyed, KeyedState) or len(keys) < 2:
        return [capture_entry(keyed, key) for key in keys]
    slots = [keyed._slots[key] for key in keys]
    if any(slot >= keyed.capacity for slot in slots):
        return [capture_entry(keyed, key) for key in keys]
    leaves, treedef = tree_flatten(keyed.stacked)
    live = _gather_rows(leaves, slots)
    entries = [{"state": _split_rows(live, treedef, i), "ring": []} for i in range(len(keys))]
    for cap, snap in keyed._ring or ():
        inside = [i for i, slot in enumerate(slots) if slot < cap]
        rows = _gather_rows(tree_flatten(snap)[0], [slots[i] for i in inside]) if inside else []
        at = {i: j for j, i in enumerate(inside)}
        for i, entry in enumerate(entries):
            entry["ring"].append(_split_rows(rows, treedef, at[i]) if i in at else None)
    rot = int(keyed.rotations)
    for entry in entries:
        entry["rot"] = rot
    return entries


def _write_row(leaves: List[torch.Tensor], slot: int, row: Any, treedef: Any) -> None:
    for leaf, new in zip(leaves, leaves_like(row, treedef)):
        leaf[slot].copy_(_as_state_tensor(new, leaf.device))


def _scatter_ring_row(keyed: KeyedState, slot: int, pos: int, row: Any) -> None:
    ring = keyed._ring
    cap, snap = ring[pos]
    leaves = tree_flatten(snap)[0]
    if slot >= cap:
        # the segment snapshot predates this slot: grow it so the readmitted
        # contribution has a row to land in (ring segments are clones no graph
        # reads, so new tensors are safe here)
        pad = keyed.capacity - cap
        leaves = [torch.cat([leaf, init.expand((pad,) + init.shape)], dim=0)
                  for leaf, init in zip(leaves, keyed._init_leaves)]
        cap = keyed.capacity
    _write_row(leaves, slot, _ordered_like(row, _like(keyed)), keyed._treedef)
    ring[pos] = (cap, tree_unflatten(leaves, keyed._treedef))


def restore_entry(keyed: Any, key: Hashable, entry: Dict[str, Any]) -> None:
    """Readmit a captured entry into an already-allocated slot.

    Each captured ring row lands at its absolute segment index (rows whose
    segment aged out of the window are dropped); the captured live state lands
    in the slab if no rotation happened since capture, otherwise in the ring
    segment the live segment became — exactly where a never-demoted twin's
    contribution would sit. A stacked slab is written in place.
    """
    rot = int(entry.get("rot", keyed.rotations))
    shift = keyed.rotations - rot
    rows = list(entry.get("ring") or [])
    state = entry.get("state")
    ring = keyed._ring
    cur_len = len(ring) if ring is not None else 0
    base = keyed.rotations - cur_len  # absolute index of ring[0]
    if isinstance(keyed, KeyedState):
        keyed.ensure_capacity()
        slot = keyed._slots[key]
        for j, row in enumerate(rows):
            if row is None:
                continue
            pos = (rot - len(rows) + j) - base
            if 0 <= pos < cur_len:
                _scatter_ring_row(keyed, slot, pos, row)
        if state is not None:
            if shift == 0:
                state = _ordered_like(state, _like(keyed))
                _write_row(keyed.leaves(), slot, state, keyed._treedef)
            else:
                pos = rot - base
                if 0 <= pos < cur_len:
                    _scatter_ring_row(keyed, slot, pos, state)
        return
    device = _device_of(keyed)
    for j, row in enumerate(rows):
        if row is None:
            continue
        pos = (rot - len(rows) + j) - base
        if 0 <= pos < cur_len:
            ring[pos][key] = _on_device(row, device)
    if state is not None and shift == 0:
        keyed.set_state(key, _on_device(state, device))
    else:
        keyed.slot_for(key)  # ensure an init live state exists
        if state is not None and shift > 0:
            pos = rot - base
            if 0 <= pos < cur_len:
                ring[pos][key] = _on_device(state, device)


def peek_state(metric: Any, keyed: Any, entry: Dict[str, Any], *, window: bool) -> Any:
    """Read of a non-resident entry — no readmission, no slab writes — as
    tensors on the keyed state's device.

    Returns what ``state_of`` (``window=False``) or ``merged_state``
    (``window=True``) would return had the tenant been readmitted first.
    """
    device = _device_of(keyed)
    like = metric.init_state()
    rot = int(entry.get("rot", keyed.rotations))
    shift = keyed.rotations - rot
    state = entry.get("state")
    if state is not None:
        state = _on_device(_ordered_like(state, like), device)
    live = state if (state is not None and shift == 0) else None
    ring = getattr(keyed, "_ring", None)
    if not window or not ring:
        return live if live is not None else metric.init_state()
    base = keyed.rotations - len(ring)
    rows = list(entry.get("ring") or [])
    contributions: List[Tuple[int, Any]] = []
    for j, row in enumerate(rows):
        if row is None:
            continue
        abs_idx = rot - len(rows) + j
        if abs_idx >= base:
            contributions.append((abs_idx, _on_device(_ordered_like(row, like), device)))
    if state is not None and shift > 0 and rot >= base:
        contributions.append((rot, state))
    contributions.sort(key=lambda t: t[0])
    merged = None
    for _, row in contributions:
        merged = row if merged is None else metric.merge_states(merged, row)
    if live is not None:
        merged = live if merged is None else metric.merge_states(merged, live)
    return merged if merged is not None else metric.init_state()


# ------------------------------------------------------------------------ policy


class TierManager:
    """Warm mirror + cold manifest + eviction policy for one engine."""

    def __init__(self, cfg: TierConfig, metric: Any) -> None:
        self.cfg = cfg
        self.metric = metric
        self.warm: Dict[Hashable, Dict[str, Any]] = {}
        self.cold: Dict[Hashable, Optional[str]] = {}  # key -> spill file, None = init
        self.pinned: Set[Hashable] = set()
        self.store: Optional[ColdStore] = (
            ColdStore(cfg.spill_directory, durable=cfg.durable)
            if cfg.spill_directory
            else None
        )
        self._heat: Dict[Hashable, float] = {}  # key -> last-active clock stamp
        self._next_check = 0.0

    # -------------------------------------------------------------- residency map

    def has(self, key: Hashable) -> bool:
        return key in self.warm or key in self.cold

    def tier_of(self, key: Hashable) -> Optional[str]:
        if key in self.warm:
            return WARM
        if key in self.cold:
            return COLD
        return None

    def keys(self) -> Tuple[Hashable, ...]:
        return tuple(self.warm) + tuple(self.cold)

    def register_cold(self, key: Hashable) -> bool:
        """Register a tenant with no state yet: a cold, init-valued resident.

        Costs one dict entry — this is what lets a million registered tenants
        coexist with a bounded slab.
        """
        if key in self.warm or key in self.cold:
            return False
        self.cold[key] = None
        return True

    def discard(self, key: Hashable) -> None:
        """Drop any non-resident record for ``key`` (it went hot, or was evicted)."""
        self.warm.pop(key, None)
        name = self.cold.pop(key, None)
        if name and self.store is not None:
            self.store.delete(name)

    def pop_entry(self, key: Hashable) -> Tuple[Optional[Dict[str, Any]], Optional[str]]:
        """Remove and return (entry, source_tier) for a non-resident tenant.

        A cold tenant's blob is read back through the ``MTCKPT1`` restore path;
        its spill file is NOT deleted here — the caller deletes only after the
        promotion is journaled, so recovery can never dangle on a pointer whose
        promote record hasn't landed.
        """
        entry = self.warm.pop(key, None)
        if entry is not None:
            return entry, WARM
        if key in self.cold:
            name = self.cold.pop(key)
            if name is None:
                return None, COLD
            assert self.store is not None
            entry = self.store.load(name)
            entry["_spill_file"] = name
            return entry, COLD
        return None, None

    def peek_entry(self, key: Hashable) -> Optional[Dict[str, Any]]:
        """Read a non-resident tenant's entry without changing its residency."""
        entry = self.warm.get(key)
        if entry is not None:
            return entry
        if key in self.cold:
            name = self.cold[key]
            if name is None:
                return None
            assert self.store is not None
            return self.store.load(name)
        return None

    # ------------------------------------------------------------------- idleness

    def touch(self, key: Hashable) -> None:
        """Record activity: stamp the tenant's last-active instant."""
        self._heat[key] = self.cfg.clock()

    def idleness(self, key: Hashable) -> float:
        """Seconds since last touch, saturating at ``idle_demote_s``."""
        stamp = self._heat.get(key)
        if stamp is None:
            return self.cfg.idle_demote_s
        idle = self.cfg.clock() - stamp
        cap = self.cfg.idle_demote_s
        return cap if idle > cap else (idle if idle > 0 else 0.0)

    def forget_heat(self, key: Hashable) -> None:
        self._heat.pop(key, None)

    # --------------------------------------------------------------------- policy

    def due(self, hot_count: int) -> bool:
        """Cheap gate for the between-batches pass: over cap, or cadence elapsed."""
        if hot_count > self.cfg.hot_capacity:
            return True
        now = self.cfg.clock()
        if now >= self._next_check:
            self._next_check = now + self.cfg.check_interval_s
            return True
        return False

    def victims(
        self, hot_keys: Any, need: int, quarantined: Set[Hashable]
    ) -> List[Hashable]:
        """Pick ``need`` demotion victims: quarantined first, then coldest."""
        if need <= 0:
            return []
        scored = []
        for i, key in enumerate(hot_keys):
            if key in self.pinned:
                continue
            scored.append((key in quarantined, self.idleness(key), -i, key))
        scored.sort(key=lambda t: (t[0], t[1], t[2]), reverse=True)
        return [t[3] for t in scored[:need]]

    def spill_victims(self) -> List[Hashable]:
        """Warm tenants to push to disk (oldest demotions first)."""
        if self.cfg.warm_capacity is None or self.store is None:
            return []
        excess = len(self.warm) - self.cfg.warm_capacity
        if excess <= 0:
            return []
        return list(self.warm)[:excess]

    # --------------------------------------------------------------- reset / views

    def reset(self) -> List[str]:
        """Zero every non-resident tenant (engine ``reset()``): all become
        cold-with-init. Returns the orphaned spill file names for the caller
        to delete (after the reset is journaled)."""
        orphans = [name for name in self.cold.values() if name]
        for key in list(self.warm):
            self.cold[key] = None
        self.warm.clear()
        for key in list(self.cold):
            self.cold[key] = None
        self._heat.clear()
        return orphans

    def snapshot_view(self) -> Dict[str, Any]:
        """The snapshot section for a partially-resident engine: the warm
        mirror rides in the snapshot by value, cold tenants by manifest
        pointer (the spill files are already durable containers)."""
        return {
            "warm": [[key, entry] for key, entry in self.warm.items()],
            "cold": [[key, name] for key, name in self.cold.items()],
            "pinned": list(self.pinned),
            "spill_directory": self.store.directory if self.store else None,
        }

    def restore_view(self, view: Dict[str, Any]) -> None:
        """Inherit a residency map (recovery, follower bootstrap, promotion)."""
        self.warm = {key: entry for key, entry in view.get("warm") or []}
        self.cold = {key: name for key, name in view.get("cold") or []}
        self.pinned = set(view.get("pinned") or [])
        self._heat.clear()
        spill_dir = view.get("spill_directory")
        if self.store is None and spill_dir:
            self.store = ColdStore(spill_dir, durable=self.cfg.durable)
