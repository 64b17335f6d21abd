"""Coordination store — CAS-with-TTL leases, membership records, fenced epochs
(port of ``metrics_tpu/cluster/store.py``).

The cluster plane's single source of truth is one tiny replicated-by-the-
filesystem (or in-memory, for tests) record set:

- **Lease**: at most one writable leader per cluster, expressed as a
  compare-and-swap grant with a TTL. The lease **epoch** is the repl plane's
  fencing epoch — a grant at epoch ``E`` means the holder promotes/ships at
  ``E`` and every older epoch is fenceable at the transport boundary, so
  losing the lease IS losing the ability to write into the lineage.
- **Membership**: one heartbeat record per node (role, replica lag,
  bootstrap/health status, heartbeat instant) — the failure detector's and
  the election's shared input.

Two backends, one contract:

- :class:`FakeCoordStore` — in-memory dict + injectable clock
  (:class:`ManualClock`), the deterministic test double. ``partition(node)``
  simulates a node cut off from the store (its calls raise
  :class:`~metrics_tpu_torch.cluster.errors.CoordStoreError`) without stopping the
  other nodes.
- :class:`DirectoryCoordStore` — a shared directory, the same idioms as
  ``ckpt.store``/``DirectoryTransport``: CRC-framed JSON records committed by
  atomic rename, and the lease CAS implemented as an **exclusive hard-link of
  a fully-written temp file onto the epoch-numbered lease path** — POSIX
  guarantees at most one linker wins ``lease-<epoch>``, so two candidates
  racing an expired lease cannot both acquire epoch ``E+1``.

Epoch monotonicity: a fresh grant's epoch is ``max(current + 1, epoch_floor)``
— the floor lets the first leader align the lease epoch with its existing
repl lineage epoch, after which grants advance strictly by CAS.

Named leases: every lease call takes ``name=""`` (the cluster-wide default
lease, bit-for-bit the pre-partition behaviour and file layout). A non-empty
name scopes an *independent* lease — its own holder, epoch chain, and CAS —
which is how the partition plane (``metrics_tpu_torch.part``) runs P concurrent
leaderships over ONE membership record set: lease ``p0003`` moving never
touches lease ``p0005``.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from metrics_tpu_torch.ckpt.store import atomic_write
from metrics_tpu_torch.cluster.errors import ClusterConfigError, CoordStoreError
from metrics_tpu_torch.guard.faults import ManualClock

__all__ = [
    "CoordStore",
    "DirectoryCoordStore",
    "FakeCoordStore",
    "Lease",
    "ManualClock",
    "Member",
]


@dataclass(frozen=True)
class Lease:
    """One leadership grant: ``holder`` may write at ``epoch`` until ``deadline``
    (store-clock time). Expiry is a property of the observer's ``store.now()``,
    never of the holder's local clock — all lease math happens in one clock."""

    holder: str
    epoch: int
    deadline: float

    def remaining(self, now: float) -> float:
        return self.deadline - now

    def expired(self, now: float) -> bool:
        return now >= self.deadline


@dataclass(frozen=True)
class Member:
    """One node's membership heartbeat: everything the failure detector and
    the election need to rank it. ``lag_seqs`` is -1 when unknown/unbounded."""

    node_id: str
    role: str  # "leader" | "follower"
    health: str  # SERVING | DEGRADED | QUARANTINED
    bootstrapped: bool
    lag_seqs: int
    heartbeat: float  # store-clock instant of this record
    # piggybacked telemetry snapshot (metrics_tpu_torch.obs.fleet.node_snapshot):
    # None unless obs is enabled on the publishing node — the leader merges
    # these into the fleet-wide Prometheus view; never used for ranking
    fleet: Optional[Dict[str, Any]] = None
    # per-partition election inputs (metrics_tpu_torch.part): partition name →
    # {"bootstrapped": bool, "lag": int, "role": str}. None outside the
    # partition plane; ``lag_seqs``/``bootstrapped`` above stay the
    # whole-node view the single-lease election ranks on
    parts: Optional[Dict[str, Any]] = None


class CoordStore:
    """The coordination contract both backends implement.

    Every method is atomic with respect to every other (in-process lock for
    the fake, filesystem atomicity for the directory store). Store
    unavailability raises :class:`CoordStoreError` — callers treat it exactly
    like lease loss, never as success."""

    def now(self) -> float:
        """The store's clock: the ONE clock all lease math uses."""
        raise NotImplementedError

    def read_lease(self, name: str = "") -> Optional[Lease]:
        """The current (possibly already expired) lease, or None before the
        first grant. Expired leases stay visible: candidates need the epoch.
        ``name`` selects an independent named lease ("" = cluster-wide)."""
        raise NotImplementedError

    def acquire_lease(
        self, node_id: str, ttl_s: float, *, epoch_floor: int = 0, name: str = ""
    ) -> Optional[Lease]:
        """CAS grant/renewal; returns the held lease, or None if lost.

        - current holder, unexpired: renewal — same epoch, deadline extended;
        - no lease / expired lease: fresh grant at
          ``max(current epoch + 1, epoch_floor)`` — at most one caller wins;
        - someone else's unexpired lease: None.

        Each ``name`` is its own independent grant/epoch chain.
        """
        raise NotImplementedError

    def release_lease(self, node_id: str, name: str = "") -> None:
        """Voluntary step-down: expire the lease NOW iff ``node_id`` holds it
        (best effort — absorbing store failures is the caller's contract)."""
        raise NotImplementedError

    def heartbeat(self, member: Member) -> None:
        """Publish/refresh one node's membership record."""
        raise NotImplementedError

    def members(self) -> Dict[str, Member]:
        """Every published membership record, by node id."""
        raise NotImplementedError

    def close(self) -> None:
        pass


# ------------------------------------------------------------------ fake store


class FakeCoordStore(CoordStore):
    """In-memory backend with an injectable clock — the deterministic double.

    ``clock`` is any ``() -> float`` (a :class:`ManualClock` in tests,
    ``time.monotonic`` for single-process live use). ``partition(node)``
    makes that node's store calls raise :class:`CoordStoreError` until
    ``heal(node)`` — a node cut off from coordination, with everyone else
    still served, which is exactly the split the at-most-one-writer test
    races."""

    def __init__(self, clock: Optional[Callable[[], float]] = None) -> None:
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._leases: Dict[str, Lease] = {}  # lease name ("" = cluster-wide) → grant
        self._members: Dict[str, Member] = {}
        self._partitioned: Set[str] = set()

    def now(self) -> float:
        return float(self._clock())

    def partition(self, node_id: str) -> None:
        with self._lock:
            self._partitioned.add(node_id)

    def heal(self, node_id: str) -> None:
        with self._lock:
            self._partitioned.discard(node_id)

    def _check_reachable(self, node_id: str) -> None:
        if node_id in self._partitioned:
            raise CoordStoreError(f"node {node_id!r} is partitioned from the coordination store")

    def read_lease(self, name: str = "") -> Optional[Lease]:
        with self._lock:
            return self._leases.get(name)

    def acquire_lease(
        self, node_id: str, ttl_s: float, *, epoch_floor: int = 0, name: str = ""
    ) -> Optional[Lease]:
        if ttl_s <= 0:
            raise ClusterConfigError(f"lease ttl must be > 0, got {ttl_s}")
        now = self.now()
        with self._lock:
            self._check_reachable(node_id)
            cur = self._leases.get(name)
            if cur is not None and cur.holder == node_id and not cur.expired(now):
                granted = Lease(node_id, cur.epoch, now + ttl_s)  # renewal: epoch pinned
            elif cur is None or cur.expired(now):
                epoch = max((cur.epoch if cur is not None else 0) + 1, int(epoch_floor))
                granted = Lease(node_id, epoch, now + ttl_s)
            else:
                return None
            self._leases[name] = granted
            return granted

    def release_lease(self, node_id: str, name: str = "") -> None:
        now = self.now()
        with self._lock:
            self._check_reachable(node_id)
            cur = self._leases.get(name)
            if cur is not None and cur.holder == node_id and not cur.expired(now):
                self._leases[name] = Lease(cur.holder, cur.epoch, now)

    def heartbeat(self, member: Member) -> None:
        with self._lock:
            self._check_reachable(member.node_id)
            self._members[member.node_id] = member

    def members(self) -> Dict[str, Member]:
        with self._lock:
            return dict(self._members)


# ------------------------------------------------------------- directory store

_CRC = struct.Struct("<II")  # (payload length, crc32)
_LEASE_PREFIX = "lease-"
_RENEW_PREFIX = "renew-"
_MEMBER_PREFIX = "member-"
_REC_SUFFIX = ".rec"
_TMP_PREFIX = ".tmp-cluster-"


def _frame_record(doc: Dict) -> bytes:
    payload = json.dumps(doc, sort_keys=True).encode()
    return _CRC.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload


def _read_record(path: str) -> Optional[Dict]:
    """Parse one CRC-framed JSON record; None for missing/torn/corrupt files
    (a torn record is indistinguishable from no record — both are retried)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if len(data) < _CRC.size:
        return None
    n, crc = _CRC.unpack_from(data, 0)
    payload = data[_CRC.size : _CRC.size + n]
    if len(payload) != n or (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        return None
    try:
        return json.loads(payload.decode())
    except (ValueError, UnicodeDecodeError):
        return None


class DirectoryCoordStore(CoordStore):
    """Shared-directory backend — cross-process coordination on one host (or
    any shared filesystem), the cluster twin of ``DirectoryTransport``.

    Layout (all CRC-framed JSON):

    - ``lease-<epoch>.rec`` — one grant, committed by exclusive hard-link:
      the grant is fully written (and optionally fsynced) as a temp file,
      then ``os.link``-ed onto the epoch path — ``EEXIST`` means another
      candidate won that epoch, and a reader can never observe a torn grant.
    - ``renew-<epoch>.rec`` — the holder's deadline extensions (only the
      holder writes it, so plain atomic rename suffices).
    - ``member-<node>.rec`` — membership heartbeats, atomic rename.

    The store clock is wall time (``time.time``): every process on the shared
    filesystem sees the same one, which is the property lease math needs
    (monotonic clocks are per-process). TTLs must therefore dwarf expected
    wall skew between hosts — on one host (the soak) skew is zero.
    """

    def __init__(self, root: str, *, durable: bool = True) -> None:
        self.root = os.path.abspath(root)
        self.durable = durable
        os.makedirs(self.root, exist_ok=True)

    def now(self) -> float:
        return time.time()

    # ------------------------------------------------------------ lease files

    @staticmethod
    def _check_name(name: str) -> str:
        # "" is the cluster-wide lease (legacy filenames, no scope segment).
        # Non-empty names become a filename segment between the prefix and the
        # 12-digit epoch, so they must not contain "-" (the epoch separator)
        # or anything a filesystem dislikes
        if name and not all(c.isalnum() or c == "_" for c in name):
            raise ClusterConfigError(
                f"lease name must be alphanumeric/underscore, got {name!r}"
            )
        return name

    def _scope(self, name: str) -> str:
        return f"{self._check_name(name)}-" if name else ""

    def _lease_path(self, epoch: int, name: str = "") -> str:
        return os.path.join(
            self.root, f"{_LEASE_PREFIX}{self._scope(name)}{epoch:012d}{_REC_SUFFIX}"
        )

    def _renew_path(self, epoch: int, name: str = "") -> str:
        return os.path.join(
            self.root, f"{_RENEW_PREFIX}{self._scope(name)}{epoch:012d}{_REC_SUFFIX}"
        )

    def _lease_epochs(self, name: str = "") -> List[int]:
        try:
            names = os.listdir(self.root)
        except OSError as exc:
            raise CoordStoreError(f"coordination directory unreadable: {exc}") from exc
        prefix = _LEASE_PREFIX + self._scope(name)
        out = []
        for fn in names:
            if fn.startswith(prefix) and fn.endswith(_REC_SUFFIX):
                try:
                    # for name="" a named grant ("p3-000000000001") fails the
                    # int() parse and is skipped — scopes never bleed together
                    out.append(int(fn[len(prefix) : -len(_REC_SUFFIX)]))
                except ValueError:
                    continue
        return sorted(out)

    def _load_lease(self, epoch: int, name: str = "") -> Optional[Lease]:
        doc = _read_record(self._lease_path(epoch, name))
        if doc is None:
            return None
        deadline = float(doc["granted_at"]) + float(doc["ttl_s"])
        renew = _read_record(self._renew_path(epoch, name))
        if renew is not None and int(renew.get("epoch", -1)) == epoch:
            deadline = max(deadline, float(renew["deadline"])) if renew.get("extend", True) \
                else float(renew["deadline"])
        return Lease(str(doc["holder"]), epoch, deadline)

    def read_lease(self, name: str = "") -> Optional[Lease]:
        # newest-first scan, skipping torn grants — same shape as the snapshot
        # store's latest_valid(): a candidate that crashed mid-commit must not
        # wedge the cluster (its linked file is complete by construction, but a
        # half-written legacy/foreign file must not either)
        for epoch in reversed(self._lease_epochs(name)):
            lease = self._load_lease(epoch, name)
            if lease is not None:
                return lease
        return None

    def acquire_lease(
        self, node_id: str, ttl_s: float, *, epoch_floor: int = 0, name: str = ""
    ) -> Optional[Lease]:
        if ttl_s <= 0:
            raise ClusterConfigError(f"lease ttl must be > 0, got {ttl_s}")
        now = self.now()
        cur = self.read_lease(name)
        if cur is not None and cur.holder == node_id and not cur.expired(now):
            # renewal: only the holder writes renew-<epoch>, atomic rename —
            # and a renewal never resurrects an EXPIRED lease (that path falls
            # through to the CAS below, where it races everyone else fairly)
            granted = Lease(node_id, cur.epoch, now + ttl_s)
            try:
                atomic_write(
                    self._renew_path(cur.epoch, name),
                    _frame_record({"epoch": cur.epoch, "deadline": granted.deadline}),
                    durable=self.durable,
                )
            except OSError as exc:
                raise CoordStoreError(f"lease renewal write failed: {exc}") from exc
            return granted
        if cur is not None and not cur.expired(now):
            return None
        target = max((cur.epoch if cur is not None else 0) + 1, int(epoch_floor))
        path = self._lease_path(target, name)
        tmp = os.path.join(
            self.root, f"{_TMP_PREFIX}{node_id}-{self._scope(name)}{target}-{os.getpid()}"
        )
        try:
            with open(tmp, "wb") as f:
                f.write(_frame_record({"holder": node_id, "granted_at": now, "ttl_s": float(ttl_s)}))
                f.flush()
                if self.durable:
                    os.fsync(f.fileno())
            try:
                os.link(tmp, path)  # the CAS: exactly one linker wins this epoch
            except FileExistsError:
                return None
            finally:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        except OSError as exc:
            raise CoordStoreError(f"lease CAS failed: {exc}") from exc
        # floors can make targets non-adjacent: if a concurrent candidate
        # committed a HIGHER epoch between our scan and our link, the higher
        # grant wins (read_lease returns it) — concede rather than split-brain
        for epoch in reversed(self._lease_epochs(name)):
            if epoch <= target:
                break
            higher = self._load_lease(epoch, name)
            if higher is not None and not higher.expired(now):
                return None
        return Lease(node_id, target, now + ttl_s)

    def release_lease(self, node_id: str, name: str = "") -> None:
        now = self.now()
        cur = self.read_lease(name)
        if cur is not None and cur.holder == node_id and not cur.expired(now):
            try:
                atomic_write(
                    self._renew_path(cur.epoch, name),
                    _frame_record({"epoch": cur.epoch, "deadline": now, "extend": False}),
                    durable=self.durable,
                )
            except OSError as exc:
                raise CoordStoreError(f"lease release write failed: {exc}") from exc

    # ------------------------------------------------------------- membership

    def _member_path(self, node_id: str) -> str:
        return os.path.join(self.root, f"{_MEMBER_PREFIX}{node_id}{_REC_SUFFIX}")

    def heartbeat(self, member: Member) -> None:
        doc = {
            "node_id": member.node_id,
            "role": member.role,
            "health": member.health,
            "bootstrapped": bool(member.bootstrapped),
            "lag_seqs": int(member.lag_seqs),
            "heartbeat": float(member.heartbeat),
        }
        if member.fleet is not None:
            doc["fleet"] = member.fleet
        if member.parts is not None:
            doc["parts"] = member.parts
        try:
            atomic_write(self._member_path(member.node_id), _frame_record(doc), durable=False)
        except OSError as exc:
            raise CoordStoreError(f"membership heartbeat write failed: {exc}") from exc

    def members(self) -> Dict[str, Member]:
        try:
            names = os.listdir(self.root)
        except OSError as exc:
            raise CoordStoreError(f"coordination directory unreadable: {exc}") from exc
        out: Dict[str, Member] = {}
        for name in names:
            if not (name.startswith(_MEMBER_PREFIX) and name.endswith(_REC_SUFFIX)):
                continue
            doc = _read_record(os.path.join(self.root, name))
            if doc is None:
                continue  # torn heartbeat: the next one replaces it
            out[str(doc["node_id"])] = Member(
                node_id=str(doc["node_id"]),
                role=str(doc["role"]),
                health=str(doc["health"]),
                bootstrapped=bool(doc["bootstrapped"]),
                lag_seqs=int(doc["lag_seqs"]),
                heartbeat=float(doc["heartbeat"]),
                fleet=doc.get("fleet"),
                parts=doc.get("parts"),
            )
        return out
