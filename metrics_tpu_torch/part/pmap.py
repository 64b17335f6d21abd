"""PartitionMap — tenant → partition assignment, pinned in a manifest (port of
``metrics_tpu/part/pmap.py``).

The partition plane's routing truth is the same seeded consistent-hash ring
the shard plane uses (:mod:`metrics_tpu_torch.shard.ring` — PYTHONHASHSEED-
independent, stable across processes), plus two small tables the ring cannot
express:

- **overrides**: tenants moved by a live migration. A migrated tenant keeps
  its ring position (the ring is immutable for a fixed partition count) and
  is re-routed by an explicit ``stable_key_bytes``-keyed entry — committed
  atomically in the manifest as the migration's routing commit point.
- **epoch floors**: per-partition minimum election epochs. A migration into
  partition ``p`` records ``floor = current epoch + 1`` so no later leader of
  ``p`` can promote at-or-below the epoch the handoff happened in — frames
  from before the migration can never be confused with frames after it.

``partition_manifest.json`` mirrors the shard plane's ``shard_manifest.json``
contract: ring parameters (partitions/vnodes/seed) are pinned at first
construction and a restart with different parameters is a crash at
construction, never silent re-routing away from the WAL that holds a tenant.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Hashable, Optional

from metrics_tpu_torch.shard.ring import DEFAULT_VNODES, HashRing, stable_key_bytes
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

__all__ = ["PartitionMap", "partition_name"]

_MANIFEST = "partition_manifest.json"


def partition_name(pid: int) -> str:
    """The stable lease/link name for partition ``pid`` ("p0", "p1", ...).
    This string keys the named lease, the per-partition repl links, and the
    obs series label — alphanumeric by construction (see the coordination
    store's lease-name charset)."""
    return f"p{int(pid)}"


class PartitionMap:
    """Tenant → partition routing: seeded ring + migration overrides + floors.

    ``directory`` (optional) pins the map in ``partition_manifest.json`` —
    construction verifies ring parameters against an existing manifest (crash
    on mismatch) and loads its overrides/floors; :meth:`commit` atomically
    persists the current tables (the migration commit point). Without a
    directory the map is in-memory only (tests, repl-less topologies).
    """

    def __init__(
        self,
        partitions: int,
        *,
        vnodes: int = DEFAULT_VNODES,
        seed: int = 0,
        directory: Optional[str] = None,
    ) -> None:
        if int(partitions) < 1:
            raise MetricsTPUUserError(f"PartitionMap needs >= 1 partition, got {partitions}")
        self._partitions = int(partitions)
        self._vnodes = int(vnodes)
        self._seed = int(seed)
        self._ring = HashRing(self._partitions, vnodes=self._vnodes, seed=self._seed)
        self._lock = threading.Lock()
        self._overrides: Dict[str, int] = {}  # stable_key_bytes(key).hex() -> pid
        self._floors: Dict[str, int] = {}  # partition name -> min election epoch
        self.directory = directory
        if directory is not None:
            self._check_or_load_manifest()

    # ------------------------------------------------------------------ routing

    @property
    def partitions(self) -> int:
        return self._partitions

    @property
    def ring(self) -> HashRing:
        return self._ring

    def names(self) -> tuple:
        return tuple(partition_name(pid) for pid in range(self._partitions))

    def name_of(self, pid: int) -> str:
        if not 0 <= int(pid) < self._partitions:
            raise MetricsTPUUserError(
                f"partition {pid} out of range [0, {self._partitions})"
            )
        return partition_name(pid)

    def partition_of(self, key: Hashable) -> int:
        """The partition currently routing ``key``: override first, then ring."""
        hexkey = stable_key_bytes(key).hex()
        with self._lock:
            pid = self._overrides.get(hexkey)
        return pid if pid is not None else self._ring.shard_for(key)

    def epoch_floor(self, pid: int) -> int:
        with self._lock:
            return self._floors.get(partition_name(pid), 0)

    # ---------------------------------------------------------------- mutation

    def set_override(self, key: Hashable, pid: int) -> None:
        """Pin ``key`` to partition ``pid`` (a completed migration's routing).
        An override landing the key back on its ring partition is dropped —
        the table holds only genuine exceptions."""
        pid = int(pid)
        if not 0 <= pid < self._partitions:
            raise MetricsTPUUserError(
                f"partition {pid} out of range [0, {self._partitions})"
            )
        hexkey = stable_key_bytes(key).hex()
        with self._lock:
            if self._ring.shard_for(key) == pid:
                self._overrides.pop(hexkey, None)
            else:
                self._overrides[hexkey] = pid

    def clear_override(self, key: Hashable) -> None:
        with self._lock:
            self._overrides.pop(stable_key_bytes(key).hex(), None)

    def set_epoch_floor(self, pid: int, floor: int) -> None:
        """Raise partition ``pid``'s minimum election epoch (monotone: a lower
        floor never overwrites a higher one)."""
        name = self.name_of(pid)
        with self._lock:
            self._floors[name] = max(int(floor), self._floors.get(name, 0))

    # ---------------------------------------------------------------- manifest

    def _manifest_doc(self) -> Dict:
        return {
            "partitions": self._partitions,
            "vnodes": self._vnodes,
            "seed": self._seed,
            "overrides": dict(self._overrides),
            "epoch_floors": dict(self._floors),
        }

    def _check_or_load_manifest(self) -> None:
        path = os.path.join(self.directory, _MANIFEST)
        if not os.path.exists(path):
            self.commit()
            return
        with open(path, "r", encoding="utf-8") as fh:
            have = json.load(fh)
        want = (self._partitions, self._vnodes, self._seed)
        got = (int(have.get("partitions", 0)), int(have.get("vnodes", 0)), int(have.get("seed", 0)))
        if got != want:
            raise MetricsTPUUserError(
                f"partition manifest at {path} was written with "
                f"partitions={got[0]}, vnodes={got[1]}, seed={got[2]} but this map "
                f"was configured with partitions={want[0]}, vnodes={want[1]}, "
                f"seed={want[2]} — a changed ring strands tenants on partitions "
                "whose WAL no longer holds them"
            )
        with self._lock:
            self._overrides = {
                str(k): int(v) for k, v in (have.get("overrides") or {}).items()
            }
            self._floors = {
                str(k): int(v) for k, v in (have.get("epoch_floors") or {}).items()
            }

    def reload(self) -> None:
        """Re-read overrides/floors from the manifest (another process — a
        migration coordinator — may have committed since). No-op in-memory."""
        if self.directory is not None:
            self._check_or_load_manifest()

    def commit(self) -> None:
        """Atomically persist the map (tmp + fsync + rename) — the migration
        routing commit point. Raises without a directory."""
        if self.directory is None:
            raise MetricsTPUUserError("PartitionMap.commit() needs a manifest directory")
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, _MANIFEST)
        tmp = path + ".tmp"
        with self._lock:
            doc = self._manifest_doc()
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
