"""Replication links: how (snapshot, WAL tail) frames travel primary → follower
(port of ``metrics_tpu/repl/transport.py``).

A :class:`ReplTransport` is the frame-level boundary of the replication plane,
mirroring the JAX package's ``comm.transport`` shape: concrete links for real
deployments, an in-process loopback for tests, and fault doubles that wrap any
inner link. The contract is a one-way ordered stream of :class:`ShipFrame`\\ s
(:class:`SnapshotFrame` / :class:`WalFrame` / :class:`HeartbeatFrame`) plus a
tiny backchannel (``request_snapshot``) a lagging follower uses to ask for a
fresh bootstrap instead of waiting out the primary's checkpoint interval.

**Fencing is enforced at this boundary.** Every frame carries the sender's
epoch; :meth:`ReplTransport.fence` raises the link's minimum acceptable epoch
(monotone). After a promotion fences the link, a deposed primary's late
shipments are rejected — on the send side with :class:`FencedError` where the
sender can see the fence (loopback shares the object, the directory link reads
the fence file), and unconditionally on the receive side, where the check is
authoritative (``fenced_rejected`` counts the drops). A zombie primary can
therefore never leak a write into a promoted follower's lineage.

Concrete links:

- :class:`LoopbackLink` — in-process deque + condvar; the unit-test and
  single-process (thread-per-replica) link.
- :class:`DirectoryTransport` — a spool directory of CRC-checked, atomically
  renamed frame files; works across processes on one host (the kill-soak's
  link) and over any shared filesystem.
- :class:`SocketShipSender` / :class:`SocketShipReceiver` — length-prefixed
  frames over TCP for real two-host pairs (fencing is receiver-side).
- :class:`FlakyLink` / :class:`StallLink` / :class:`DeadPeerLink` — fault
  injectors mirroring the comm plane's Flaky/Stall/DeadPeer taxonomy (Prime
  PCCL's failure model: peers join, lag, and die without stopping the service).
"""

from __future__ import annotations

import io
import os
import pickle
import select
import socket
import struct
import threading
import time
import zlib
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

from metrics_tpu_torch.ckpt.store import atomic_write
from metrics_tpu_torch.repl.errors import FencedError, ReplPeerLostError, ReplTransportError

__all__ = [
    "DeadPeerLink",
    "DirectoryTransport",
    "FanoutTransport",
    "FlakyLink",
    "HeartbeatFrame",
    "LoopbackLink",
    "ReplTransport",
    "ShipFrame",
    "SnapshotFrame",
    "SocketShipReceiver",
    "SocketShipSender",
    "StallLink",
    "WalFrame",
]


# ------------------------------------------------------------------------- frames


class ShipFrame:
    """Base of the three wire frames; ``epoch`` is the sender's fencing token."""

    __slots__ = ("epoch", "t_wall")

    def __init__(self, epoch: int, t_wall: float) -> None:
        self.epoch = int(epoch)
        self.t_wall = float(t_wall)


class SnapshotFrame(ShipFrame):
    """One full engine snapshot: ``data`` is the committed container bytes
    (``None`` = empty bootstrap — the follower starts from fresh init state),
    ``seq`` the WAL position the snapshot covers. ``bootstrap`` marks a
    (re)bootstrap ship — fresh attach, backchannel request, or a WAL-tail
    discontinuity where rotation GC'd records before they were ever shipped:
    the records up to ``seq`` will NEVER arrive as WalFrames, so a follower
    behind ``seq`` must restore rather than wait on the chain. Routine
    new-generation ships (``bootstrap=False``) are droppable by a follower
    whose seq chain is intact."""

    __slots__ = ("generation", "seq", "data", "bootstrap")

    def __init__(
        self,
        epoch: int,
        generation: int,
        seq: int,
        data: Optional[bytes],
        t_wall: float,
        bootstrap: bool = False,
    ) -> None:
        super().__init__(epoch, t_wall)
        self.generation = int(generation)
        self.seq = int(seq)
        self.data = data
        self.bootstrap = bool(bootstrap)


class WalFrame(ShipFrame):
    """One journaled record, exactly as the primary's WAL framed it."""

    __slots__ = ("seq", "payload")

    def __init__(self, epoch: int, seq: int, payload: bytes, t_wall: float) -> None:
        super().__init__(epoch, t_wall)
        self.seq = int(seq)
        self.payload = payload


class HeartbeatFrame(ShipFrame):
    """Primary liveness + position: lets a caught-up follower keep its
    ``seconds_behind`` near zero even when no traffic flows.

    ``fleet`` piggybacks the primary's telemetry snapshot
    (:func:`metrics_tpu_torch.obs.fleet.node_snapshot`) on the channel the pair
    already owns — None unless obs is enabled on the sender. Frames pickled by
    an older build restore without the slot; read it with
    ``getattr(frame, "fleet", None)``.
    """

    __slots__ = ("last_seq", "fleet")

    def __init__(
        self,
        epoch: int,
        last_seq: int,
        t_wall: float,
        fleet: Optional[Dict[str, Any]] = None,
    ) -> None:
        super().__init__(epoch, t_wall)
        self.last_seq = int(last_seq)
        self.fleet = fleet


_FRAME_CLASSES = {"ShipFrame": ShipFrame, "SnapshotFrame": SnapshotFrame, "WalFrame": WalFrame,
                  "HeartbeatFrame": HeartbeatFrame}
_FRAME_MODULES = ("metrics_tpu.repl.transport", "metrics_tpu_torch.repl.transport")


class _FrameUnpickler(pickle.Unpickler):
    """Reads a pickled frame batch of either package: the four frame classes of
    ``metrics_tpu.repl.transport`` (a JAX primary's spool) and of this module
    map to this module's classes; every other global is refused, so a spool
    file or a socket peer can name no callable."""

    def find_class(self, module: str, name: str) -> Any:
        if module in _FRAME_MODULES and name in _FRAME_CLASSES:
            return _FRAME_CLASSES[name]
        raise pickle.UnpicklingError(f"replication frame batch names a foreign global {module}.{name}")


def loads_frames(payload: bytes) -> List[ShipFrame]:
    """Decode one pickled frame batch (either package's frames; nothing else)."""
    return list(_FrameUnpickler(io.BytesIO(payload)).load())


# ----------------------------------------------------------------------- contract


class ReplTransport:
    """Frame-level replication boundary: ordered one-way stream + fence."""

    name = "repl"
    # capability flag: True when request_snapshot/take_snapshot_request are a
    # real follower→primary channel. The shipper keys its routine-ship policy
    # on this — backchannel links suppress routine new-generation snapshots
    # (the follower asks when it needs one); backchannel-less links rely on
    # them, with the WAL tail rewound under each, as the only gap-heal path.
    has_backchannel = False

    def __init__(self) -> None:
        self._fence_lock = threading.Lock()
        self._fenced_epoch = 0
        self.fenced_rejected = 0  # frames dropped at the receive-side fence check

    # -------------------------------------------------------------- ship side

    def send(self, frames: Sequence[ShipFrame]) -> None:
        """Publish frames in order. Raises :class:`FencedError` when the sender's
        epoch is below the fence (where the fence is visible to the sender)."""
        raise NotImplementedError

    # ----------------------------------------------------------- receive side

    def recv(self, timeout_s: float = 0.0) -> List[ShipFrame]:
        """Every frame available now (waiting up to ``timeout_s`` for the first),
        in ship order, fenced frames already dropped."""
        raise NotImplementedError

    # ---------------------------------------------------------------- fencing

    def fence(self, epoch: int) -> None:
        """Reject every frame with ``frame.epoch < epoch`` from now on (monotone)."""
        with self._fence_lock:
            self._fenced_epoch = max(self._fenced_epoch, int(epoch))

    @property
    def fenced_epoch(self) -> int:
        return self._fenced_epoch

    def _check_send_epoch(self, frames: Sequence[ShipFrame]) -> None:
        fence = self._fenced_epoch
        for frame in frames:
            if frame.epoch < fence:
                raise FencedError(
                    f"shipment at epoch {frame.epoch} rejected: link fenced at epoch {fence} "
                    "(a newer primary was promoted)"
                )

    def _filter_fenced(self, frames: List[ShipFrame]) -> List[ShipFrame]:
        fence = self._fenced_epoch
        kept = [f for f in frames if f.epoch >= fence]
        self.fenced_rejected += len(frames) - len(kept)
        return kept

    # ------------------------------------------------------------ backchannel

    def request_snapshot(self) -> None:
        """Follower → primary: 'I need a fresh bootstrap'. Optional; links
        without a backchannel (``has_backchannel`` False) no-op — there the
        shipper ships each new generation routinely with the WAL tail rewound
        under it, so rejoin latency is bounded by the ckpt interval."""

    def take_snapshot_request(self) -> bool:
        """Primary-side poll: consume one pending snapshot request."""
        return False

    def close(self) -> None:
        pass


# ----------------------------------------------------------------- loopback link


class LoopbackLink(ReplTransport):
    """In-process link: one deque, condvar-signalled — primary and follower in
    the same process (tests, thread-per-replica deployments). The fence is one
    shared token, so it is enforced on BOTH sides."""

    name = "loopback"
    has_backchannel = True

    def __init__(self, maxlen: Optional[int] = 8192) -> None:
        super().__init__()
        self._cond = threading.Condition()
        # bounded by default for the same reason DirectoryTransport caps its
        # spool: a wedged in-process follower must not grow the SHARED
        # process's memory until the primary OOMs with it. deque(maxlen)
        # drops the OLDEST frames; the follower sees the seq gap and
        # re-bootstraps over the backchannel — the protocol's normal heal
        # path. maxlen=None opts back into an unbounded link.
        self._frames: deque = deque(maxlen=maxlen)
        self._snap_request = threading.Event()

    def send(self, frames: Sequence[ShipFrame]) -> None:
        self._check_send_epoch(frames)
        with self._cond:
            self._frames.extend(frames)
            self._cond.notify_all()

    def recv(self, timeout_s: float = 0.0) -> List[ShipFrame]:
        with self._cond:
            if not self._frames and timeout_s > 0:
                self._cond.wait(timeout_s)
            out = list(self._frames)
            self._frames.clear()
        # frames enqueued before the fence rose are still subject to it
        return self._filter_fenced(out)

    @property
    def pending(self) -> int:
        with self._cond:
            return len(self._frames)

    def request_snapshot(self) -> None:
        self._snap_request.set()

    def take_snapshot_request(self) -> bool:
        was_set = self._snap_request.is_set()
        self._snap_request.clear()
        return was_set


# ---------------------------------------------------------------- directory link

_DIR_PREFIX = "ship-"
_DIR_SUFFIX = ".frm"
_FENCE_NAME = "FENCE"
_SNAPREQ_NAME = "SNAPREQ"
_CRC = struct.Struct("<I")


class DirectoryTransport(ReplTransport):
    """Frame spool in a shared directory — the cross-process link on one host
    (or any shared filesystem). Each ``send`` commits one serial-numbered,
    CRC-checked file via the ckpt plane's atomic temp+rename, so the receiver
    never observes a torn batch; ``recv`` consumes files in serial order and
    deletes them (the spool stays bounded by the follower's lag).

    The fence is a ``FENCE`` file holding the epoch: ``fence()`` commits it,
    senders re-read it before every publish (send-side rejection), and the
    receive-side filter re-checks each frame — authoritative even when a racing
    sender's file landed between the fence commit and its next read.
    """

    name = "directory"
    has_backchannel = True

    def __init__(self, root: str, *, durable: bool = False, max_spool_files: int = 8192) -> None:
        super().__init__()
        self.root = os.path.abspath(root)
        self.durable = durable
        # "the spool stays bounded by the follower's lag" only holds while a
        # follower is consuming — a permanently dead one would otherwise grow
        # the spool without bound until the DISK fills (and take the ckpt
        # plane's own writes down with it on a shared filesystem). Beyond the
        # cap the OLDEST batches drop: a returning follower sees the seq gap
        # and re-bootstraps — exactly the protocol's normal heal path, so
        # bounding the spool costs one snapshot restore, not correctness.
        self.max_spool_files = int(max_spool_files)
        self.spool_dropped = 0
        os.makedirs(self.root, exist_ok=True)
        serials = self._serials()
        self._next_serial = (serials[-1] + 1) if serials else 0
        self._trim_floor = serials[0] if serials else 0  # lowest serial possibly on disk

    def _serials(self) -> List[int]:
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        for name in names:
            if name.startswith(_DIR_PREFIX) and name.endswith(_DIR_SUFFIX):
                try:
                    out.append(int(name[len(_DIR_PREFIX) : -len(_DIR_SUFFIX)]))
                except ValueError:
                    continue
        return sorted(out)

    def _path(self, serial: int) -> str:
        return os.path.join(self.root, f"{_DIR_PREFIX}{serial:016d}{_DIR_SUFFIX}")

    def _disk_fence(self) -> int:
        try:
            with open(os.path.join(self.root, _FENCE_NAME), "rb") as f:
                return int(f.read().decode() or 0)
        except (OSError, ValueError):
            return 0

    def fence(self, epoch: int) -> None:
        super().fence(epoch)
        current = max(self._disk_fence(), self._fenced_epoch)
        atomic_write(
            os.path.join(self.root, _FENCE_NAME), str(current).encode(), durable=self.durable
        )

    def send(self, frames: Sequence[ShipFrame]) -> None:
        if not frames:
            return
        # the on-disk fence is the shared token: a promotion in another process
        # must depose this sender too
        with self._fence_lock:
            self._fenced_epoch = max(self._fenced_epoch, self._disk_fence())
        self._check_send_epoch(frames)
        payload = pickle.dumps(list(frames), protocol=pickle.HIGHEST_PROTOCOL)
        blob = _CRC.pack(zlib.crc32(payload) & 0xFFFFFFFF) + payload
        atomic_write(self._path(self._next_serial), blob, durable=self.durable)
        self._next_serial += 1
        if self.max_spool_files > 0:
            # serials are dense from this sender, so the cap walks a floor —
            # no listdir on the publish hot path (a remove that fails was
            # already consumed by a live follower, which is the common case)
            floor = self._next_serial - self.max_spool_files
            while self._trim_floor < floor:
                try:
                    os.remove(self._path(self._trim_floor))
                    self.spool_dropped += 1
                except OSError:
                    pass
                self._trim_floor += 1

    def recv(self, timeout_s: float = 0.0) -> List[ShipFrame]:
        deadline = time.monotonic() + timeout_s
        while True:
            with self._fence_lock:
                self._fenced_epoch = max(self._fenced_epoch, self._disk_fence())
            out: List[ShipFrame] = []
            for serial in self._serials():
                path = self._path(serial)
                try:
                    with open(path, "rb") as f:
                        blob = f.read()
                    os.remove(path)
                except OSError:
                    continue
                if len(blob) < _CRC.size:
                    continue
                (crc,) = _CRC.unpack_from(blob)
                payload = blob[_CRC.size :]
                if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                    continue  # torn/corrupt spool file: skip, the WAL seq chain catches gaps
                try:
                    out.extend(loads_frames(payload))
                except Exception:  # noqa: BLE001 — a corrupt batch is a gap, not a crash
                    continue
            if out or time.monotonic() >= deadline:
                return self._filter_fenced(out)
            time.sleep(0.005)

    def request_snapshot(self) -> None:
        atomic_write(os.path.join(self.root, _SNAPREQ_NAME), b"1", durable=self.durable)

    def take_snapshot_request(self) -> bool:
        try:
            os.remove(os.path.join(self.root, _SNAPREQ_NAME))
            return True
        except OSError:
            return False


# ------------------------------------------------------------------- socket link

_SOCK_LEN = struct.Struct("<Q")


class SocketShipReceiver(ReplTransport):
    """Listening end of a TCP ship link (the follower). Accepts one sender at a
    time (reconnects allowed — a restarted primary re-attaches), buffers frames
    on a background thread; fencing is enforced here, the authoritative side."""

    name = "socket"

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        super().__init__()
        self._cond = threading.Condition()
        self._frames: deque = deque()
        self._closed = False
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, port))
        self._server.listen(1)
        self._server.settimeout(0.2)
        self.host, self.port = self._server.getsockname()
        self._thread = threading.Thread(
            target=self._serve, name="metrics-tpu-repl-recv", daemon=True
        )
        self._thread.start()

    def _serve(self) -> None:
        # one active sender at a time, NEWEST connection wins: a live zombie
        # primary holding the old connection must not starve a replacement
        # primary out of the accept queue forever — the takeover closes the
        # zombie's socket, and once any replacement frame reaches the applier
        # the higher epoch makes it drop the zombie's stragglers too
        conn: Optional[socket.socket] = None
        buf = b""
        try:
            while not self._closed:
                watch = [self._server] if conn is None else [self._server, conn]
                try:
                    readable, _, _ = select.select(watch, [], [], 0.2)
                except (OSError, ValueError):
                    if conn is not None:
                        conn.close()
                        conn, buf = None, b""
                        continue
                    return
                if self._server in readable:
                    try:
                        new_conn, _ = self._server.accept()
                    except OSError:
                        return
                    if conn is not None:
                        try:
                            conn.close()
                        except OSError:
                            pass
                    conn, buf = new_conn, b""
                    continue  # re-select: the fresh sender may already have data
                if conn is None or conn not in readable:
                    continue
                try:
                    chunk = conn.recv(1 << 16)
                except OSError:
                    chunk = b""
                if not chunk:
                    conn.close()
                    conn, buf = None, b""
                    continue
                buf += chunk
                while len(buf) >= _SOCK_LEN.size:
                    (n,) = _SOCK_LEN.unpack_from(buf)
                    if len(buf) < _SOCK_LEN.size + n:
                        break
                    payload = buf[_SOCK_LEN.size : _SOCK_LEN.size + n]
                    buf = buf[_SOCK_LEN.size + n :]
                    try:
                        frames = loads_frames(payload)
                    except Exception:  # noqa: BLE001 — corrupt batch = gap, WAL chain catches it
                        continue
                    with self._cond:
                        self._frames.extend(frames)
                        self._cond.notify_all()
        finally:
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass

    def send(self, frames: Sequence[ShipFrame]) -> None:
        raise ReplTransportError("SocketShipReceiver is the receiving end; ship via SocketShipSender")

    def recv(self, timeout_s: float = 0.0) -> List[ShipFrame]:
        with self._cond:
            if not self._frames and timeout_s > 0:
                self._cond.wait(timeout_s)
            out = list(self._frames)
            self._frames.clear()
        return self._filter_fenced(out)

    def close(self) -> None:
        self._closed = True
        try:
            self._server.close()
        except OSError:
            pass


class SocketShipSender(ReplTransport):
    """Connecting end of a TCP ship link (the primary). Lazily connects;
    transient socket failures surface as :class:`ReplTransportError` (the
    shipper retries next tick, reconnecting). The fence here is local-process
    only — the receiver's check is what actually stops a remote zombie."""

    name = "socket"

    def __init__(self, host: str, port: int, *, connect_timeout_s: float = 5.0) -> None:
        super().__init__()
        self._addr = (host, int(port))
        self._connect_timeout_s = connect_timeout_s
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def _connected(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection(self._addr, timeout=self._connect_timeout_s)
            s.settimeout(self._connect_timeout_s)
            self._sock = s
        return self._sock

    def send(self, frames: Sequence[ShipFrame]) -> None:
        if not frames:
            return
        self._check_send_epoch(frames)
        payload = pickle.dumps(list(frames), protocol=pickle.HIGHEST_PROTOCOL)
        with self._lock:
            try:
                sock = self._connected()
                sock.sendall(_SOCK_LEN.pack(len(payload)) + payload)
            except OSError as exc:
                self._drop_connection()
                raise ReplTransportError(f"ship link send failed: {exc!r}") from exc

    def recv(self, timeout_s: float = 0.0) -> List[ShipFrame]:
        raise ReplTransportError("SocketShipSender is the shipping end; receive via SocketShipReceiver")

    def _drop_connection(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._drop_connection()


# ----------------------------------------------------------------- fault doubles


class FlakyLink(ReplTransport):
    """Fail the first ``fail`` sends, then delegate — the transient-fault
    injector for shipper-retry tests (mirrors the JAX package's ``comm.FlakyTransport``)."""

    name = "flaky"

    def __init__(
        self,
        inner: ReplTransport,
        fail: int = 1,
        exc: Callable[[], Exception] = ReplTransportError,
    ) -> None:
        super().__init__()
        self._inner = inner
        self._remaining = int(fail)
        self._exc = exc
        self.failures_injected = 0

    @property
    def has_backchannel(self) -> bool:  # type: ignore[override]
        return self._inner.has_backchannel

    def send(self, frames: Sequence[ShipFrame]) -> None:
        if self._remaining > 0:
            self._remaining -= 1
            self.failures_injected += 1
            raise self._exc()
        self._inner.send(frames)

    def recv(self, timeout_s: float = 0.0) -> List[ShipFrame]:
        return self._inner.recv(timeout_s)

    def fence(self, epoch: int) -> None:
        self._inner.fence(epoch)

    @property
    def fenced_epoch(self) -> int:  # type: ignore[override]
        return self._inner.fenced_epoch

    def request_snapshot(self) -> None:
        self._inner.request_snapshot()

    def take_snapshot_request(self) -> bool:
        return self._inner.take_snapshot_request()

    def close(self) -> None:
        self._inner.close()


class StallLink(FlakyLink):
    """Sleep ``stall_s`` before the first ``stalls`` sends complete — what a
    wedged/slow link looks like to the ship loop (lag grows, nothing is lost)."""

    name = "stall"

    def __init__(self, inner: ReplTransport, stall_s: float, stalls: int = 1) -> None:
        super().__init__(inner, fail=0)
        self._stall_s = float(stall_s)
        self._stalls = int(stalls)

    def send(self, frames: Sequence[ShipFrame]) -> None:
        if self._stalls > 0:
            self._stalls -= 1
            time.sleep(self._stall_s)
        self._inner.send(frames)


class DeadPeerLink(FlakyLink):
    """Every send fails with :class:`ReplPeerLostError` — the follower is gone;
    the primary keeps serving (shipping degrades, availability does not)."""

    name = "dead_peer"

    def __init__(self, inner: Optional[ReplTransport] = None) -> None:
        super().__init__(inner if inner is not None else LoopbackLink(), fail=0)

    def send(self, frames: Sequence[ShipFrame]) -> None:
        raise ReplPeerLostError("follower left the membership")


# -------------------------------------------------------------------- fan-out


class FanoutTransport(ReplTransport):
    """Ship-side fan-out: one primary publishing ONE lineage to N followers,
    each over its own single-consumer link (the engine still wires one
    transport — this is the "transport-layer extension" the one-follower
    contract pointed at: one primary, many followers).

    Semantics:

    - ``send`` publishes to every link. A :class:`FencedError` from ANY link
      means a newer primary exists somewhere — the send raises it (the shipper
      parks as deposed). Non-fence failures on a SUBSET of links are absorbed
      (``partial_failures`` counts them): a dead follower must not stop
      shipping to the live ones — it re-bootstraps off its own link's snapshot
      path when it returns. Only when EVERY link fails does the send raise.
    - ``fence`` propagates to every link (and the local floor).
    - the backchannel aggregates: one follower's snapshot request triggers one
      bootstrap ship, which ``send`` fans to everyone (a redundant bootstrap
      at/behind a healthy follower's position is dropped by its applier).
    - ``recv`` is not a thing: the primary's applier never reads a fan-out.
    """

    name = "fanout"

    def __init__(self, links: Sequence[ReplTransport]) -> None:
        super().__init__()
        if not links:
            raise ReplTransportError("FanoutTransport needs at least one link")
        self._links = list(links)
        # the shipper keys its routine-ship policy on this: with any
        # backchannel-less link in the set, routine new-generation ships are
        # the only gap-heal path that reaches it
        self.has_backchannel = all(link.has_backchannel for link in self._links)
        self.partial_failures = 0

    @property
    def links(self) -> List[ReplTransport]:
        return list(self._links)

    def send(self, frames: Sequence[ShipFrame]) -> None:
        self._check_send_epoch(frames)
        fenced: Optional[FencedError] = None
        errors: List[BaseException] = []
        for link in self._links:
            try:
                link.send(frames)
            except FencedError as exc:
                fenced = exc
            except Exception as exc:  # noqa: BLE001 — per-link isolation
                errors.append(exc)
        if fenced is not None:
            raise fenced
        if errors:
            if len(errors) == len(self._links):
                raise errors[0] if isinstance(errors[0], ReplTransportError) else \
                    ReplTransportError(f"every fan-out link failed: {errors[0]!r}")
            self.partial_failures += len(errors)

    def recv(self, timeout_s: float = 0.0) -> List[ShipFrame]:
        raise ReplTransportError("FanoutTransport is ship-side only; followers receive on their own link")

    def fence(self, epoch: int) -> None:
        super().fence(epoch)
        for link in self._links:
            try:
                link.fence(epoch)
            except Exception:  # noqa: BLE001 — best effort; each receive side re-checks
                pass

    def request_snapshot(self) -> None:
        pass  # ship-side only

    def take_snapshot_request(self) -> bool:
        pending = False
        for link in self._links:
            try:
                if link.take_snapshot_request():
                    pending = True
            except Exception:  # noqa: BLE001
                continue
        return pending

    def close(self) -> None:
        for link in self._links:
            try:
                link.close()
            except Exception:  # noqa: BLE001
                pass
