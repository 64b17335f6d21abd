"""The port's replication links (``metrics_tpu_torch/repl/transport.py``) against
the JAX package's (``tests/repl/test_transport.py`` has their twins): frame order,
fencing at the boundary on both sides, the spool's bounds and fence file, the TCP
link and the fault doubles.

Across the packages: a JAX sender's ``DirectoryTransport`` spool (frames pickled
under ``metrics_tpu.repl.transport`` names) is read by the port's transport into
the port's frame classes, and the reverse; the port's unpickler refuses every
global that is not one of the four frame classes, so a spool file or a socket
peer can name no callable. Every wait is bounded.
"""

import os
import pickle
import time

import pytest

import metrics_tpu.repl as jrepl
from metrics_tpu_torch.repl import (
    DeadPeerLink,
    DirectoryTransport,
    FanoutTransport,
    FencedError,
    FlakyLink,
    HeartbeatFrame,
    LoopbackLink,
    ReplPeerLostError,
    ReplTransportError,
    ShipFrame,
    SnapshotFrame,
    SocketShipReceiver,
    SocketShipSender,
    StallLink,
    WalFrame,
)
from metrics_tpu_torch.repl.transport import loads_frames


def _wal(seq, epoch=0, payload=b"r"):
    return WalFrame(epoch, seq, payload, t_wall=1000.0 + seq)


def _spool_files(path):
    return [n for n in os.listdir(path) if n.endswith(".frm")]


# --------------------------------------------------------------------------- loopback


def test_loopback_frames_arrive_in_ship_order():
    link = LoopbackLink()
    link.send([_wal(0), _wal(1)])
    link.send([HeartbeatFrame(0, 1, 1002.0)])
    frames = link.recv()
    assert [type(f).__name__ for f in frames] == ["WalFrame", "WalFrame", "HeartbeatFrame"]
    assert [f.seq for f in frames[:2]] == [0, 1]
    assert link.recv() == []


def test_loopback_recv_waits_up_to_timeout():
    link = LoopbackLink()
    t0 = time.monotonic()
    assert link.recv(timeout_s=0.05) == []
    assert time.monotonic() - t0 >= 0.04


def test_loopback_send_side_fence_raises():
    link = LoopbackLink()
    link.fence(2)
    with pytest.raises(FencedError):
        link.send([_wal(0, epoch=1)])
    link.send([_wal(0, epoch=2)])  # the promoted epoch still ships
    assert [f.epoch for f in link.recv()] == [2]


def test_loopback_recv_side_fence_drops_already_enqueued_frames():
    link = LoopbackLink()
    link.send([_wal(0, epoch=0), _wal(1, epoch=0)])
    link.fence(1)
    assert link.recv() == []
    assert link.fenced_rejected == 2


def test_fence_is_monotone():
    link = LoopbackLink()
    link.fence(3)
    link.fence(1)
    assert link.fenced_epoch == 3


def test_loopback_snapshot_request_backchannel():
    link = LoopbackLink()
    assert not link.take_snapshot_request()
    link.request_snapshot()
    assert link.take_snapshot_request()
    assert not link.take_snapshot_request()  # consumed


def test_loopback_is_bounded_and_drops_the_oldest():
    link = LoopbackLink(maxlen=3)
    link.send([_wal(i) for i in range(5)])
    assert link.pending == 3
    assert [f.seq for f in link.recv()] == [2, 3, 4]


# --------------------------------------------------------------------------- directory spool


def test_directory_roundtrip_across_instances(tmp_path):
    sender = DirectoryTransport(str(tmp_path))
    receiver = DirectoryTransport(str(tmp_path))
    sender.send([SnapshotFrame(0, 0, 5, b"snapbytes", 1.0)])
    sender.send([_wal(6), _wal(7)])
    frames = receiver.recv()
    assert isinstance(frames[0], SnapshotFrame) and frames[0].data == b"snapbytes"
    assert [f.seq for f in frames[1:]] == [6, 7]
    assert receiver.recv() == []  # consumed files are deleted
    assert not _spool_files(tmp_path)


def test_directory_spool_bounded_with_dead_consumer(tmp_path):
    sender = DirectoryTransport(str(tmp_path), max_spool_files=5)
    for i in range(20):
        sender.send([_wal(i)])
    assert len(_spool_files(tmp_path)) == 5
    assert sender.spool_dropped == 15
    assert [f.seq for f in DirectoryTransport(str(tmp_path)).recv()] == list(range(15, 20))


def test_directory_fence_file_deposes_other_process_sender(tmp_path):
    sender = DirectoryTransport(str(tmp_path))
    DirectoryTransport(str(tmp_path)).fence(2)  # the promoted node's handle
    with pytest.raises(FencedError):
        sender.send([_wal(0, epoch=0)])


def test_directory_recv_drops_fenced_spool_files(tmp_path):
    DirectoryTransport(str(tmp_path)).send([_wal(0, epoch=0)])
    receiver = DirectoryTransport(str(tmp_path))
    receiver.fence(1)
    assert receiver.recv() == []
    assert receiver.fenced_rejected == 1


def test_directory_corrupt_spool_file_is_skipped_not_fatal(tmp_path):
    DirectoryTransport(str(tmp_path)).send([_wal(0)])
    path = os.path.join(str(tmp_path), _spool_files(tmp_path)[0])
    with open(path, "r+b") as f:
        f.seek(6)
        f.write(b"\xff\xff")
    assert DirectoryTransport(str(tmp_path)).recv() == []


def test_directory_snapshot_request_file(tmp_path):
    follower = DirectoryTransport(str(tmp_path))
    primary = DirectoryTransport(str(tmp_path))
    follower.request_snapshot()
    assert primary.take_snapshot_request()
    assert not primary.take_snapshot_request()


def test_directory_sender_serial_resumes_after_restart(tmp_path):
    DirectoryTransport(str(tmp_path)).send([_wal(0)])
    DirectoryTransport(str(tmp_path)).send([_wal(1)])  # a restarted sender
    assert [f.seq for f in DirectoryTransport(str(tmp_path)).recv()] == [0, 1]


def test_directory_recv_waits_up_to_timeout(tmp_path):
    t0 = time.monotonic()
    assert DirectoryTransport(str(tmp_path)).recv(timeout_s=0.05) == []
    assert time.monotonic() - t0 >= 0.04


# --------------------------------------------------------------------------- across the packages


def _jax_frames():
    return [
        jrepl.SnapshotFrame(3, 7, 41, b"MTCKPT1-bytes", 1.5, bootstrap=True),
        jrepl.WalFrame(3, 42, b"C-record", 1.6),
        jrepl.HeartbeatFrame(3, 42, 1.7, {"kind": "metrics_tpu-fleet-node", "node": "primary:0"}),
    ]


def _assert_frames_equal(got, want, cls):
    assert [type(f).__name__ for f in got] == [type(f).__name__ for f in want]
    for g, w in zip(got, want):
        assert isinstance(g, cls)
        for slot in ("epoch", "t_wall", "seq", "generation", "data", "bootstrap", "payload", "last_seq", "fleet"):
            assert getattr(g, slot, None) == getattr(w, slot, None), slot


def test_a_jax_spool_is_read_into_the_port_frames(tmp_path):
    jrepl.DirectoryTransport(str(tmp_path)).send(_jax_frames())
    got = DirectoryTransport(str(tmp_path)).recv()
    _assert_frames_equal(got, _jax_frames(), ShipFrame)
    assert all(type(f).__module__ == "metrics_tpu_torch.repl.transport" for f in got)


def test_a_port_spool_is_read_by_the_jax_transport(tmp_path):
    """The spool's files (CRC, serials, fence) are one format: the JAX package's
    plain unpickler reads a port spool, resolving the port's frame classes."""
    frames = [SnapshotFrame(2, 1, 9, b"x", 2.0), WalFrame(2, 10, b"R", 2.1), HeartbeatFrame(2, 10, 2.2)]
    DirectoryTransport(str(tmp_path)).send(frames)
    _assert_frames_equal(jrepl.DirectoryTransport(str(tmp_path)).recv(), frames, ShipFrame)


def test_a_jax_fence_file_deposes_a_port_sender_and_the_reverse(tmp_path):
    jrepl.DirectoryTransport(str(tmp_path / "a")).fence(4)
    with pytest.raises(FencedError):
        DirectoryTransport(str(tmp_path / "a")).send([_wal(0, epoch=3)])
    DirectoryTransport(str(tmp_path / "b")).fence(4)
    with pytest.raises(jrepl.FencedError):
        jrepl.DirectoryTransport(str(tmp_path / "b")).send([jrepl.WalFrame(3, 0, b"r", 1.0)])


class _Foreign:
    def __reduce__(self):
        return (os.getcwd, ())


@pytest.mark.parametrize("payload", [
    pickle.dumps([_Foreign()]),
    pickle.dumps([_wal(0), {"cls": ReplTransportError("x")}]),
    pickle.dumps(print),
])
def test_the_unpickler_refuses_a_foreign_global(payload):
    with pytest.raises(pickle.UnpicklingError, match="foreign global"):
        loads_frames(payload)


def test_a_spool_file_naming_a_foreign_global_is_skipped(tmp_path):
    import struct
    import zlib

    payload = pickle.dumps([_Foreign()])
    with open(os.path.join(str(tmp_path), "ship-0000000000000000.frm"), "wb") as f:
        f.write(struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF) + payload)
    DirectoryTransport(str(tmp_path)).send([_wal(1)])  # serial 1, after the foreign file
    assert [f.seq for f in DirectoryTransport(str(tmp_path)).recv()] == [1]


# --------------------------------------------------------------------------- TCP


def _recv_until(receiver, n, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    frames = []
    while len(frames) < n and time.monotonic() < deadline:
        frames += receiver.recv(timeout_s=0.1)
    return frames


def test_socket_roundtrip_over_tcp():
    receiver = SocketShipReceiver()
    sender = SocketShipSender("127.0.0.1", receiver.port)
    try:
        sender.send([_wal(0), _wal(1)])
        assert [f.seq for f in _recv_until(receiver, 2)] == [0, 1]
    finally:
        sender.close()
        receiver.close()


def test_socket_receiver_side_fencing():
    receiver = SocketShipReceiver()
    sender = SocketShipSender("127.0.0.1", receiver.port)
    try:
        receiver.fence(1)
        sender.send([_wal(0, epoch=0)])
        sender.send([_wal(1, epoch=1)])
        assert [f.seq for f in _recv_until(receiver, 1)] == [1]
        assert receiver.fenced_rejected == 1
    finally:
        sender.close()
        receiver.close()


def test_socket_replacement_sender_preempts_zombie_connection():
    receiver = SocketShipReceiver()
    zombie = SocketShipSender("127.0.0.1", receiver.port)
    replacement = SocketShipSender("127.0.0.1", receiver.port)
    try:
        zombie.send([_wal(0, epoch=0)])
        frames = _recv_until(receiver, 1)
        assert frames and frames[0].epoch == 0  # the zombie holds the link
        replacement.send([_wal(0, epoch=1)])
        deadline = time.monotonic() + 5.0
        got = []
        while not any(f.epoch == 1 for f in got) and time.monotonic() < deadline:
            got += receiver.recv(timeout_s=0.1)
        assert any(f.epoch == 1 for f in got)  # not starved behind the zombie
    finally:
        zombie.close()
        replacement.close()
        receiver.close()


def test_socket_jax_sender_to_port_receiver():
    receiver = SocketShipReceiver()
    sender = jrepl.SocketShipSender("127.0.0.1", receiver.port)
    try:
        sender.send(_jax_frames())
        _assert_frames_equal(_recv_until(receiver, 3), _jax_frames(), ShipFrame)
    finally:
        sender.close()
        receiver.close()


def test_socket_send_to_dead_port_is_transport_error():
    import socket as _socket

    # a bound, never-listening socket refuses connections while we hold it
    blocker = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
    blocker.bind(("127.0.0.1", 0))
    port = blocker.getsockname()[1]
    try:
        with pytest.raises(ReplTransportError):
            SocketShipSender("127.0.0.1", port, connect_timeout_s=0.5).send([_wal(0)])
    finally:
        blocker.close()


def test_socket_ends_refuse_the_wrong_direction():
    receiver = SocketShipReceiver()
    try:
        with pytest.raises(ReplTransportError):
            receiver.send([_wal(0)])
        with pytest.raises(ReplTransportError):
            SocketShipSender("127.0.0.1", receiver.port).recv()
    finally:
        receiver.close()


# --------------------------------------------------------------------------- fault doubles and fan-out


def test_flaky_fails_then_delegates():
    inner = LoopbackLink()
    link = FlakyLink(inner, fail=2)
    for _ in range(2):
        with pytest.raises(ReplTransportError):
            link.send([_wal(0)])
    link.send([_wal(0)])
    assert link.failures_injected == 2
    assert [f.seq for f in inner.recv()] == [0]


def test_stall_delays_but_delivers():
    inner = LoopbackLink()
    link = StallLink(inner, stall_s=0.05, stalls=1)
    t0 = time.monotonic()
    link.send([_wal(0)])
    assert time.monotonic() - t0 >= 0.04
    link.send([_wal(1)])  # stall budget spent
    assert [f.seq for f in inner.recv()] == [0, 1]


def test_dead_peer_always_fails():
    with pytest.raises(ReplPeerLostError):
        DeadPeerLink().send([_wal(0)])


def test_doubles_forward_fence_and_backchannel():
    inner = LoopbackLink()
    link = FlakyLink(inner, fail=0)
    link.fence(4)
    assert inner.fenced_epoch == 4 and link.fenced_epoch == 4
    link.request_snapshot()
    assert link.take_snapshot_request()
    assert link.has_backchannel


def test_fanout_ships_to_every_link_and_isolates_a_dead_one():
    a, b = LoopbackLink(), LoopbackLink()
    fan = FanoutTransport([a, DeadPeerLink(), b])
    fan.send([_wal(0)])
    assert [f.seq for f in a.recv()] == [0] and [f.seq for f in b.recv()] == [0]
    assert fan.partial_failures == 1
    with pytest.raises(ReplTransportError):
        FanoutTransport([DeadPeerLink(), DeadPeerLink()]).send([_wal(0)])
    with pytest.raises(ReplTransportError):
        FanoutTransport([])
    with pytest.raises(ReplTransportError):
        fan.recv()


def test_fanout_fence_reaches_every_link_and_a_fenced_link_raises():
    a, b = LoopbackLink(), LoopbackLink()
    fan = FanoutTransport([a, b])
    b.fence(2)
    with pytest.raises(FencedError):
        fan.send([_wal(0, epoch=1)])
    fan.fence(3)
    assert (a.fenced_epoch, b.fenced_epoch, fan.fenced_epoch) == (3, 3, 3)
    b.request_snapshot()
    assert fan.take_snapshot_request() and not fan.take_snapshot_request()
    assert fan.has_backchannel and not FanoutTransport([a, SocketLike()]).has_backchannel


class SocketLike(LoopbackLink):
    has_backchannel = False
