"""The port's read replicas (``StreamingEngine(replication=ReplConfig(role=
"follower", ...))`` over ``metrics_tpu_torch/repl``) against the JAX package's,
on the CPU: the twins of ``tests/repl/test_follower.py``, led by three checks.

1. A port follower equals its port primary at every applied seq (every leaf
   ``torch.equal``: one engine kind, one device kind).
2. It equals the JAX follower of the same stream, each package's pair over its
   own ``LoopbackLink`` (``assert_trees_match``: int32 counts bit for bit,
   float leaves within rtol 1e-6).
3. It bootstraps from, and then tracks, a JAX primary's ``DirectoryTransport``
   spool: MTCKPT1 snapshots and WAL records written by the JAX package.

Then the read contract, staleness refusals, the config's validation, rotations
and resets replicated, the epoch bump of a restarted primary, gap parking and
the shipper's recovery paths. Every wait is bounded (``await_seq``, deadlines).
"""

import pickle
import shutil
import struct
import time

import numpy as np
import pytest
import torch

import metrics_tpu.repl as jrepl
from metrics_tpu.engine import CheckpointConfig as JaxCheckpointConfig
from metrics_tpu.engine import ReplConfig as JaxReplConfig
from metrics_tpu.engine import StreamingEngine as JaxEngine
from metrics_tpu_torch.classification import BinaryAccuracy
from metrics_tpu_torch.engine import (
    CheckpointConfig,
    NotPrimaryError,
    ReplConfig,
    ReplicaLag,
    StalenessExceeded,
    StreamingEngine,
)
from metrics_tpu_torch.repl import (
    DirectoryTransport,
    FlakyLink,
    HeartbeatFrame,
    LoopbackLink,
    ReplTransportError,
    SnapshotFrame,
    WalFrame,
)
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

from tests.test_torch_engine import FAMILIES, _stream, assert_trees_match, engine_states

WAIT_S = 20


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _metric():
    return BinaryAccuracy(device="cpu")


def _primary(tmp_path, link, metric=None, name="primary", interval_s=0.05, ship_interval_s=0.01,
             heartbeat_interval_s=0.05, window=None, **kw):
    return StreamingEngine(
        metric if metric is not None else _metric(), buckets=(8, 32), window=window,
        checkpoint=CheckpointConfig(directory=str(tmp_path / name), interval_s=interval_s, durable=False),
        replication=ReplConfig(role="primary", transport=link, ship_interval_s=ship_interval_s,
                               heartbeat_interval_s=heartbeat_interval_s, **kw),
    )


def _follower(link, metric=None, window=None, **kw):
    return StreamingEngine(
        metric if metric is not None else _metric(), buckets=(8, 32), window=window,
        replication=ReplConfig(role="follower", transport=link, poll_interval_s=0.01, **kw),
    )


def _feed(engine, seed, n=120, keys=4):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        rows = int(rng.integers(1, 7))
        engine.submit(f"t{rng.integers(0, keys)}", rng.integers(0, 2, rows).astype(np.int32),
                      rng.integers(0, 2, rows).astype(np.int32))
    engine.flush(timeout=WAIT_S)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def assert_states_equal(a_engine, b_engine):
    """Every tenant's every leaf ``torch.equal`` (dtype included)."""
    a, b = engine_states(a_engine), engine_states(b_engine)
    assert set(a) == set(b)
    for key in a:
        for x, y in zip(_leaves(a[key]), _leaves(b[key]), strict=True):
            assert x.dtype == y.dtype and torch.equal(x, y), key


def _wait(cond, timeout_s=WAIT_S):
    """Poll ``cond`` until it holds (True) or ``timeout_s`` passes (False);
    ``cond`` is called once more only while it has not held."""
    deadline = time.monotonic() + timeout_s
    while True:
        if cond():
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.01)


# --------------------------------------------------------------------------- the three checks


def test_a_port_follower_equals_its_primary_at_every_applied_seq(tmp_path):
    link = LoopbackLink()
    # no periodic snapshot: one shipper tick a submit ships exactly its record
    primary = _primary(tmp_path, link, interval_s=3600.0, ship_interval_s=3600.0, heartbeat_interval_s=3600.0)
    follower = _follower(link)
    try:
        shipper = primary._shipper
        shipper.tick()  # the empty bootstrap
        rng = np.random.default_rng(5)
        for _ in range(24):
            rows = int(rng.integers(1, 7))
            primary.submit(f"t{rng.integers(0, 3)}", rng.integers(0, 2, rows).astype(np.int32),
                           rng.integers(0, 2, rows).astype(np.int32)).result(timeout=WAIT_S)
            shipper.tick()
            assert follower._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
            assert follower._applier.applied_seq == primary._wal_seq
            assert_states_equal(primary, follower)
        assert primary._wal_seq == 23
    finally:
        primary.close(checkpoint=False)
        follower.close()


@pytest.mark.parametrize("family", ["binary_accuracy", "flagship", "quantile", "mean"])
def test_a_port_follower_equals_the_jax_follower_of_the_same_stream(family, tmp_path):
    make_jax, make_port, gen = FAMILIES[family]
    stream = _stream(gen, seed=11, n=40, keys=3)
    jlink, link = jrepl.LoopbackLink(), LoopbackLink()
    jprimary = JaxEngine(make_jax(), buckets=(8, 32), checkpoint=JaxCheckpointConfig(
        directory=str(tmp_path / "jax"), interval_s=0.05, durable=False),
        replication=JaxReplConfig(role="primary", transport=jlink, ship_interval_s=0.01, heartbeat_interval_s=0.05))
    jfollower = JaxEngine(make_jax(), buckets=(8, 32),
                          replication=JaxReplConfig(role="follower", transport=jlink, poll_interval_s=0.01))
    primary = _primary(tmp_path, link, metric=make_port())
    follower = _follower(link, metric=make_port())
    try:
        for engine in (jprimary, primary):
            for key, args in stream:
                engine.submit(key, *args)
            engine.flush(timeout=WAIT_S)
        assert jfollower._applier.await_seq(jprimary._wal_seq, timeout_s=WAIT_S)
        assert follower._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
        assert_states_equal(primary, follower)
        ports, refs = engine_states(follower), engine_states(jfollower)
        assert set(ports) == set(refs)
        for key in refs:
            assert_trees_match(ports[key], refs[key], f"{family} {key}")
        values, ref_values = follower.compute_all(), jfollower.compute_all()
        for key in ref_values:
            assert_trees_match(values[key], ref_values[key], f"{family} {key} compute")
    finally:
        for engine in (jprimary, primary):
            engine.close(checkpoint=False)
        jfollower.close()
        follower.close()


@pytest.mark.parametrize("family", ["binary_accuracy", "flagship"])
def test_a_port_follower_bootstraps_from_and_tracks_a_jax_primary_spool(family, tmp_path):
    make_jax, make_port, gen = FAMILIES[family]
    spool = str(tmp_path / "spool")
    jprimary = JaxEngine(make_jax(), buckets=(8, 32), checkpoint=JaxCheckpointConfig(
        directory=str(tmp_path / "jax"), interval_s=3600.0, durable=False),
        replication=JaxReplConfig(role="primary", transport=jrepl.DirectoryTransport(spool),
                                  ship_interval_s=0.01, heartbeat_interval_s=0.05))
    follower = None
    try:
        for key, args in _stream(gen, seed=21, n=30, keys=4):
            jprimary.submit(key, *args)
        jprimary.flush()
        jprimary.checkpoint_now()  # a JAX MTCKPT1 snapshot the follower must bootstrap from
        # the attach-time frames went to nobody: the spool starts over
        assert _wait(lambda: jprimary._shipper.last_shipped_seq == jprimary._wal_seq)
        DirectoryTransport(spool).recv()
        for key, args in _stream(gen, seed=22, n=10, keys=4):
            jprimary.submit(key, *args)
        jprimary.flush()
        follower = _follower(DirectoryTransport(spool), metric=make_port())
        assert follower._applier.await_seq(jprimary._wal_seq, timeout_s=WAIT_S)
        assert follower.telemetry_snapshot()["snapshot_loads"] >= 1
        for key, args in _stream(gen, seed=23, n=30, keys=5):
            jprimary.submit(key, *args)
        jprimary.flush()
        assert follower._applier.await_seq(jprimary._wal_seq, timeout_s=WAIT_S)
        ports, refs = engine_states(follower), engine_states(jprimary)
        assert set(ports) == set(refs)
        for key in refs:
            assert_trees_match(ports[key], refs[key], f"{family} {key}")
        assert follower.wal_watermark() == (0, jprimary._wal_seq)
    finally:
        jprimary.close(checkpoint=False)
        if follower is not None:
            follower.close()


# --------------------------------------------------------------------------- replay


def test_follower_tracks_continued_traffic(tmp_path):
    link = LoopbackLink()
    primary, follower = _primary(tmp_path, link), _follower(link)
    try:
        for seed in (1, 2, 3):
            _feed(primary, seed=seed, n=40)
            assert follower._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
            assert_states_equal(primary, follower)
        for key in primary._keyed.keys:
            assert torch.equal(follower.compute(key), primary.compute(key))
    finally:
        primary.close(checkpoint=False)
        follower.close()


def test_rejoining_follower_bootstraps_from_fresh_snapshot(tmp_path):
    link = LoopbackLink()
    primary = _primary(tmp_path, link)
    first = _follower(link)
    try:
        _feed(primary, seed=4, n=60)
        assert first._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
        first.close()  # the follower dies
        _feed(primary, seed=5, n=60)  # traffic goes on while it is gone
        primary.checkpoint_now()
        rejoined = _follower(link)
        try:
            # the rejoiner sees a mid-stream tail, detects the gap and requests a snapshot
            _feed(primary, seed=6, n=30)
            assert rejoined._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
            assert_states_equal(primary, rejoined)
            assert rejoined.telemetry_snapshot()["snapshot_loads"] >= 1
        finally:
            rejoined.close()
    finally:
        primary.close(checkpoint=False)
        first.close()


def test_unbootstrapped_follower_requests_snapshot():
    link = LoopbackLink()
    follower = _follower(link)
    try:
        assert _wait(link.take_snapshot_request, timeout_s=5), "unbootstrapped follower never asked"
    finally:
        follower.close()


def test_reset_and_rotation_replicate_and_recover(tmp_path):
    link = LoopbackLink()
    primary = _primary(tmp_path, link, name="p", interval_s=3600.0, window=2)
    follower = _follower(link, window=2)
    try:
        _feed(primary, seed=30, n=30)
        primary.rotate_window()
        _feed(primary, seed=31, n=30)
        primary.reset()
        _feed(primary, seed=32, n=30)
        assert follower._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
        assert_states_equal(primary, follower)
        for key in primary._keyed.keys:
            assert torch.equal(follower.compute(key, window=True), primary.compute(key, window=True))
        final = engine_states(primary)
        primary.close(checkpoint=False)
        recovered = StreamingEngine(_metric(), buckets=(8, 32), window=2, start=False,
                                    checkpoint=CheckpointConfig(directory=str(tmp_path / "p"), durable=False))
        try:
            for key, want in final.items():
                assert_trees_match(recovered._keyed.state_of(key), want, key)
        finally:
            recovered.close(checkpoint=False)
    finally:
        primary.close(checkpoint=False)
        follower.close()


def test_fresh_bootstrap_keeps_heartbeat_known_seq():
    follower = _follower(LoopbackLink())
    try:
        applier = follower._applier
        applier.stop()
        now = time.time()
        applier.apply_frames([HeartbeatFrame(0, 41, now)])
        applier.apply_frames([SnapshotFrame(0, -1, -1, None, now)])
        assert applier.bootstrapped and applier.lag().seqs_behind == 42
    finally:
        follower.close()


def test_convergence_under_periodic_send_failures(tmp_path):
    class EveryThirdSendFails(FlakyLink):
        def __init__(self, inner):
            super().__init__(inner, fail=0)
            self._n = 0

        def send(self, frames):
            self._n += 1
            if self._n % 3 == 0:
                self.failures_injected += 1
                raise ReplTransportError("injected periodic send failure")
            self._inner.send(frames)

    link = LoopbackLink()
    faulted = EveryThirdSendFails(link)
    primary = _primary(tmp_path, faulted, name="p", interval_s=3600.0)
    follower = _follower(link)
    try:
        for seed in (11, 12, 13):
            _feed(primary, seed=seed, n=40)
            assert follower._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
            assert_states_equal(primary, follower)
        assert faulted.failures_injected > 0
    finally:
        primary.close(checkpoint=False)
        follower.close()


def test_rotation_before_first_tail_ship_rescues_via_bootstrap_snapshot(tmp_path):
    link = LoopbackLink()
    primary = _primary(tmp_path, link, name="p", interval_s=3600.0, ship_interval_s=3600.0,
                       heartbeat_interval_s=3600.0)
    follower = _follower(link)
    try:
        primary._shipper.tick()  # empty bootstrap: no snapshot, journal starts at 0
        assert _wait(lambda: follower._applier.bootstrapped)
        assert follower._applier.applied_seq == -1
        _feed(primary, seed=40, n=30)
        primary.checkpoint_now()  # covers the whole journal; rotation removes it
        primary._shipper.tick()
        assert primary._shipper.last_shipped_seq == -1
        _feed(primary, seed=41, n=30)
        primary._shipper.tick()  # tail discontinuity → re-bootstrap
        primary._shipper.tick()  # bootstrap snapshot + tail from its seq
        assert follower._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
        assert_states_equal(primary, follower)
    finally:
        primary.close(checkpoint=False)
        follower.close()


def test_wal_loss_parks_shipper_instead_of_heartbeating_frozen_seq(tmp_path):
    link = LoopbackLink()
    primary = _primary(tmp_path, link)  # no follower: this test owns link.recv
    try:
        _feed(primary, seed=50, n=20)
        assert _wait(lambda: primary._shipper.last_shipped_seq >= primary._wal_seq)

        def _boom(payloads):
            raise OSError("disk full")

        primary._journal.append_many = _boom
        primary.submit("t0", np.array([1], np.int32), np.array([1], np.int32)).result(timeout=WAIT_S)
        primary.flush()
        assert _wait(lambda: primary._shipper.journal_lost, timeout_s=5)
        assert primary._journal is None
        assert primary.telemetry_snapshot()["ship_journal_lost"] == 1
        link.recv()
        time.sleep(0.2)  # several heartbeat intervals of silence
        assert link.pending == 0, "a parked shipper publishes nothing"
    finally:
        primary.close(checkpoint=False)


def test_bad_frame_does_not_discard_rest_of_batch():
    follower = _follower(LoopbackLink())
    try:
        applier = follower._applier
        applier.stop()
        now = time.time()
        applier.apply_frames([SnapshotFrame(0, 0, 3, b"not a snapshot container", now), HeartbeatFrame(0, 9, now)])
        assert applier.known_seq == 9  # the frame behind the bad one landed
        assert not applier.bootstrapped and applier.last_error is not None
        assert follower.telemetry_snapshot()["apply_failures"] == 1
    finally:
        follower.close()


def test_empty_bootstrap_without_any_snapshot(tmp_path):
    link = LoopbackLink()
    primary = StreamingEngine(_metric(), buckets=(8,), checkpoint=CheckpointConfig(
        directory=str(tmp_path / "p"), interval_s=3600.0, durable=False),
        replication=ReplConfig(role="primary", transport=link, ship_interval_s=0.01))
    follower = _follower(link)
    try:
        _feed(primary, seed=7, n=30)
        assert follower._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
        assert_states_equal(primary, follower)
    finally:
        primary.close(checkpoint=False)
        follower.close()


def test_same_lineage_rewind_snapshot_keeps_known_seq():
    follower = _follower(LoopbackLink())
    try:
        applier = follower._applier
        applier.stop()
        now = time.time()
        applier.apply_frames([SnapshotFrame(0, -1, -1, None, now)])
        applier.applied_seq = 1000
        applier.apply_frames([HeartbeatFrame(0, 1005, now)])
        applier._gap = True
        applier.apply_frames([SnapshotFrame(0, 3, 950, None, now + 1)])
        assert applier.applied_seq == 950 and not applier._gap and applier.known_seq == 1005
        lag = applier.lag()
        assert lag.seqs_behind == 55 and lag.seconds_behind == float("inf")
    finally:
        follower.close()


def test_epoch_bump_snapshot_resets_seq_accounting():
    follower = _follower(LoopbackLink())
    try:
        applier = follower._applier
        applier.stop()
        now = time.time()
        applier.apply_frames([SnapshotFrame(0, -1, -1, None, now)])
        applier.applied_seq = 1000
        applier.apply_frames([HeartbeatFrame(0, 1005, now)])
        applier.apply_frames([SnapshotFrame(1, -1, 40, None, now + 1)])
        assert (applier.epoch, applier.applied_seq, applier.known_seq, applier._gap) == (1, 40, 40, False)
    finally:
        follower.close()


def test_fresh_attach_to_higher_epoch_primary_keeps_heartbeat_known_seq():
    follower = _follower(LoopbackLink())
    try:
        applier = follower._applier
        applier.stop()
        now = time.time()
        applier.apply_frames([HeartbeatFrame(5, 10050, now)])
        applier.apply_frames([SnapshotFrame(5, 7, 10000, None, now, bootstrap=True)])
        assert applier.bootstrapped and applier.known_seq == 10050
        assert applier.lag().seqs_behind == 50 and applier.lag().seconds_behind == float("inf")
    finally:
        follower.close()


def test_gapped_replica_reports_unbounded_staleness():
    follower = _follower(LoopbackLink())
    try:
        applier = follower._applier
        applier.stop()
        now = time.time()
        applier.apply_frames([SnapshotFrame(0, -1, -1, None, now)])
        applier.applied_seq = 10000
        applier.apply_frames([HeartbeatFrame(1, 40, now)])  # a new lineage: a gap
        assert applier._gap and applier.lag().seconds_behind == float("inf")
    finally:
        follower.close()


def test_gapped_follower_parks_replay_until_snapshot(tmp_path):
    """A new lineage's record whose seq lands on applied + 1 must not replay onto
    the old lineage's state: replay parks until that lineage's snapshot."""
    from metrics_tpu_torch.engine.runtime import _encode_request_record

    link = LoopbackLink()
    primary, follower = _primary(tmp_path, link), _follower(link)
    try:
        _feed(primary, seed=11, n=60)
        assert follower._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
        applied, keys_before = follower._applier.applied_seq, set(follower._keyed.keys)
        payload = _encode_request_record(pickle.dumps("zz-new-lineage"),
                                         (np.asarray([1, 1], np.int32), np.asarray([0, 1], np.int32)))
        link.send([WalFrame(99, applied + 1, payload, time.time())])
        assert _wait(lambda: follower._applier.epoch == 99, timeout_s=5)
        assert follower._applier._gap and follower._applier.applied_seq == applied
        assert set(follower._keyed.keys) == keys_before
    finally:
        primary.close(checkpoint=False)
        follower.close()


def test_routine_generation_ship_retries_after_send_failure(tmp_path):
    link = LoopbackLink()

    class FailArmedSnapshotSend(FlakyLink):
        has_backchannel = False  # routine ships exist only on such links

        def __init__(self, inner):
            super().__init__(inner, fail=0)
            self.arm = False

        def send(self, frames):
            if self.arm and any(isinstance(f, SnapshotFrame) for f in frames):
                self.arm = False
                self.failures_injected += 1
                raise ReplTransportError("injected snapshot send failure")
            self._inner.send(frames)

    faulted = FailArmedSnapshotSend(link)
    primary = _primary(tmp_path, faulted, name="p", interval_s=3600.0, ship_interval_s=3600.0,
                       heartbeat_interval_s=3600.0)
    try:
        shipper = primary._shipper
        shipper.tick()
        _feed(primary, seed=60, n=10)
        primary.checkpoint_now()
        faulted.arm = True
        with pytest.raises(ReplTransportError):
            shipper.tick()
        shipper.tick()  # the next tick retries the same generation
        gens = primary._ckpt_store.generations()
        assert shipper.shipped_generation == gens[-1]
        assert any(f.generation == gens[-1] for f in link.recv() if isinstance(f, SnapshotFrame))
    finally:
        primary.close(checkpoint=False)


def test_stopped_shipper_abandons_catch_up_between_batches(tmp_path):
    link = LoopbackLink()
    primary = _primary(tmp_path, link, name="p", interval_s=3600.0, ship_interval_s=3600.0,
                       heartbeat_interval_s=3600.0)
    try:
        shipper = primary._shipper
        shipper.tick()
        _feed(primary, seed=61, n=20)
        shipper._stop.set()
        before = shipper.last_shipped_seq
        shipper._ship_tail(time.time())
        assert shipper.last_shipped_seq == before
    finally:
        primary.close(checkpoint=False)


def test_backchannel_less_gap_heals_via_rewound_routine_ship(tmp_path):
    class LossySocketLikeLink(LoopbackLink):
        has_backchannel = False
        drop_next_wal = False

        def send(self, frames):
            if self.drop_next_wal and any(isinstance(f, WalFrame) for f in frames):
                self.drop_next_wal = False
                return  # lost in flight
            super().send(frames)

    link = LossySocketLikeLink()
    primary = _primary(tmp_path, link, name="p", interval_s=3600.0, ship_interval_s=3600.0,
                       heartbeat_interval_s=3600.0)
    follower = _follower(link)
    try:
        shipper = primary._shipper
        shipper.tick()
        _feed(primary, seed=70, n=15)
        shipper.tick()
        assert follower._applier.await_seq(shipper.last_shipped_seq, timeout_s=WAIT_S)
        link.drop_next_wal = True
        _feed(primary, seed=71, n=15)
        shipper.tick()  # lost in flight
        _feed(primary, seed=72, n=15)
        shipper.tick()  # delivered past the hole: the follower gaps
        assert _wait(lambda: follower._applier._gap)
        primary.checkpoint_now()
        covered = primary._wal_seq
        _feed(primary, seed=73, n=10)
        shipper.tick()
        tip_before = shipper.last_shipped_seq
        shipper._seen_generation = None
        shipper.tick()  # routine ship: snapshot + the tail rewound under it
        assert shipper.last_shipped_seq >= tip_before
        assert follower._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
        assert not follower._applier._gap and follower._applier.applied_seq > covered
        assert_states_equal(primary, follower)
    finally:
        primary.close(checkpoint=False)
        follower.close()


def test_routine_ships_suppressed_on_backchannel_links(tmp_path):
    link = LoopbackLink()
    primary = _primary(tmp_path, link, name="p", interval_s=3600.0, ship_interval_s=3600.0,
                       heartbeat_interval_s=3600.0)
    try:
        shipper = primary._shipper
        shipper.tick()
        assert any(isinstance(f, SnapshotFrame) for f in link.recv())
        _feed(primary, seed=74, n=10)
        shipper.tick()
        link.recv()
        primary.checkpoint_now()
        _feed(primary, seed=75, n=10)
        shipper.tick()
        frames = link.recv()
        assert not any(isinstance(f, SnapshotFrame) for f in frames)
        assert any(isinstance(f, WalFrame) for f in frames)
        link.request_snapshot()
        shipper.tick()
        assert any(isinstance(f, SnapshotFrame) for f in link.recv())
    finally:
        primary.close(checkpoint=False)


def test_snapshot_wal_history_hole_parks_bootstrap(tmp_path):
    import os

    link = LoopbackLink()
    primary = _primary(tmp_path, link, name="p", interval_s=3600.0, ship_interval_s=3600.0,
                       heartbeat_interval_s=3600.0)
    try:
        shipper = primary._shipper
        for seed in (85, 86, 87):
            _feed(primary, seed=seed, n=10)
            primary.checkpoint_now()
        _feed(primary, seed=88, n=10)
        gens = primary._ckpt_store.generations()
        for g in gens[1:]:  # tear every generation newer than the oldest
            path = primary._ckpt_store.path(g)
            blob = open(path, "rb").read()
            with open(path, "wb") as fh:
                fh.write(blob[: len(blob) // 2])
        os.remove(primary._journal._segments()[0][1])  # the segment the oldest chains into
        shipper.tick()
        assert not any(isinstance(f, SnapshotFrame) for f in link.recv())
        holes = primary.telemetry_snapshot()["ship_history_holes"]
        assert holes >= 1
        shipper.tick()
        shipper.tick()
        assert primary.telemetry_snapshot()["ship_history_holes"] == holes
        healed = primary.checkpoint_now()
        shipper.tick()
        assert any(f.generation == healed for f in link.recv() if isinstance(f, SnapshotFrame))
    finally:
        primary.close(checkpoint=False)


def test_dead_link_surfaces_in_follower_health(tmp_path):
    spool = tmp_path / "spool"
    follower = _follower(DirectoryTransport(str(spool), durable=False))
    try:
        assert follower.health()["state"] == "SERVING"
        shutil.rmtree(spool)
        assert _wait(lambda: follower.health()["state"] == "DEGRADED"
                     and follower.health()["replication"]["apply_error"])
        assert "Error" in follower.health()["replication"]["apply_error"]
        spool.mkdir()
        DirectoryTransport(str(spool), durable=False).send([SnapshotFrame(0, -1, -1, None, time.time())])
        assert _wait(lambda: follower.health()["state"] == "SERVING")
        assert follower.health()["replication"]["apply_error"] is None
    finally:
        follower.close()


def test_persistent_apply_failure_stays_visible_across_idle_polls():
    link = LoopbackLink()
    follower = _follower(link)
    try:
        link.send([SnapshotFrame(0, 0, 3, b"not a snapshot container", time.time())])
        assert _wait(lambda: follower._applier.last_error is not None)
        time.sleep(0.1)  # ~10 idle polls
        assert follower._applier.last_error is not None and follower.health()["state"] == "DEGRADED"
        link.send([HeartbeatFrame(0, -1, time.time())])  # clean, but the chain is still broken
        time.sleep(0.1)
        assert follower._applier.last_error is not None and follower.health()["state"] == "DEGRADED"
        link.send([SnapshotFrame(0, -1, -1, None, time.time())])
        assert _wait(lambda: follower._applier.last_error is None)
        assert follower.health()["state"] == "SERVING"
    finally:
        follower.close()


def test_graceful_close_ships_the_final_tail(tmp_path):
    link = LoopbackLink()
    primary = _primary(tmp_path, link, name="p", interval_s=3600.0, ship_interval_s=3600.0,
                       heartbeat_interval_s=3600.0)
    follower = _follower(link)
    try:
        _feed(primary, seed=80, n=25)
        final_seq = primary._wal_seq
        primary.close()  # the final checkpoint, then the final publish
        assert follower._applier.await_seq(final_seq, timeout_s=WAIT_S)
        assert_states_equal(primary, follower)
    finally:
        primary.close()
        follower.close()


def test_restarted_primary_bumps_epoch_so_followers_rebootstrap(tmp_path):
    """The port's twin: the restart snapshot is restored into the follower's
    live slab in place (the graphs stay bound), and the follower then tracks
    the new incarnation's records."""
    link = LoopbackLink()
    first = _primary(tmp_path, link)
    follower = _follower(link)
    try:
        _feed(first, seed=90, n=30)
        assert follower._applier.await_seq(first._wal_seq, timeout_s=WAIT_S)
        slab = [t.data_ptr() for t in follower._keyed.leaves()]
        first.close(checkpoint=False)  # the WAL tail carries the rest
        restarted = _primary(tmp_path, link)  # the same directory: a resumed lineage
        try:
            assert restarted._repl_epoch == 1
            _feed(restarted, seed=91, n=20)
            assert _wait(lambda: follower._applier.epoch == 1 and not follower._applier._gap
                         and follower._applier.applied_seq == restarted._wal_seq)
            assert_states_equal(restarted, follower)
            assert [t.data_ptr() for t in follower._keyed.leaves()] == slab
            assert follower.wal_watermark() == (1, restarted._wal_seq) == restarted.wal_watermark()
        finally:
            restarted.close(checkpoint=False)
    finally:
        follower.close()


def test_replacement_primary_with_bumped_epoch_rebootstraps_follower(tmp_path):
    link = LoopbackLink()
    first = _primary(tmp_path, link)
    follower = _follower(link)
    try:
        _feed(first, seed=20, n=60)
        assert follower._applier.await_seq(first._wal_seq, timeout_s=WAIT_S)
        first.close(checkpoint=False)
        replacement = _primary(tmp_path, link, name="replacement", epoch=1)
        try:
            _feed(replacement, seed=21, n=40, keys=2)
            assert _wait(lambda: follower._applier.epoch == 1 and not follower._applier._gap
                         and follower._applier.applied_seq == replacement._wal_seq)
            assert_states_equal(replacement, follower)  # the old mirror fully replaced
        finally:
            replacement.close(checkpoint=False)
    finally:
        follower.close()


def test_an_empty_bootstrap_of_a_new_lineage_scrubs_the_slab_in_place():
    follower = _follower(LoopbackLink())
    try:
        applier = follower._applier
        applier.stop()
        now = time.time()
        applier.apply_frames([SnapshotFrame(0, -1, -1, None, now)])
        from metrics_tpu_torch.engine.runtime import _encode_request_record

        payload = _encode_request_record(pickle.dumps("a"), (np.asarray([1], np.int32), np.asarray([1], np.int32)))
        applier.apply_frames([WalFrame(0, 0, payload, now)])
        assert "a" in follower._keyed.keys
        slab = [t.data_ptr() for t in follower._keyed.leaves()]
        applier.apply_frames([SnapshotFrame(1, -1, -1, None, now + 1)])  # a wiped primary, new epoch
        assert follower._keyed.keys == () and [t.data_ptr() for t in follower._keyed.leaves()] == slab
        assert all(int(t.abs().sum()) == 0 for t in follower._keyed.leaves())
    finally:
        follower.close()


# --------------------------------------------------------------------------- the read contract


def test_follower_refuses_writes():
    follower = _follower(LoopbackLink())
    try:
        with pytest.raises(NotPrimaryError):
            follower.submit("t", np.array([1], np.int32), np.array([1], np.int32))
        for op in (follower.reset, follower.rotate_window, lambda: follower.evict_tenant("t"),
                   lambda: follower.import_tenant("t", None)):
            with pytest.raises(NotPrimaryError):
                op()
        assert follower._worker is None  # a follower has no dispatcher
    finally:
        follower.close()


def test_reads_tagged_with_replica_lag(tmp_path):
    link = LoopbackLink()
    primary, follower = _primary(tmp_path, link), _follower(link)
    try:
        _feed(primary, seed=8, n=20)
        assert follower._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
        lag = follower.replica_lag()
        assert isinstance(lag, ReplicaLag) and lag.seqs_behind == 0 and lag.seconds_behind < 30.0
        health = follower.health()["replication"]
        assert health["role"] == "follower" and health["bootstrapped"] and health["lag_seqs"] == 0
        assert primary.health()["replication"]["role"] == "primary" and primary.replica_lag() is None
    finally:
        primary.close(checkpoint=False)
        follower.close()


def test_unbootstrapped_replica_refuses_bounded_reads():
    follower = _follower(LoopbackLink(), max_staleness_s=1.0)
    try:
        with pytest.raises(StalenessExceeded):
            follower.compute("t")
        with pytest.raises(StalenessExceeded):
            follower.compute_all()
        with pytest.raises(StalenessExceeded):
            follower.wal_watermark()
        assert follower.telemetry_snapshot()["stale_read_refusals"] == 3
    finally:
        follower.close()


def test_read_refused_beyond_max_staleness_seconds(tmp_path):
    link = LoopbackLink()
    primary = _primary(tmp_path, link)
    follower = _follower(link, max_staleness_s=0.2)
    try:
        _feed(primary, seed=9, n=20)
        assert follower._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
        follower.compute("t0")  # fresh: served
        primary._shipper.close()  # silence the link: seconds_behind grows
        time.sleep(0.4)
        with pytest.raises(StalenessExceeded):
            follower.compute("t0")
    finally:
        primary.close(checkpoint=False)
        follower.close()


def test_read_refused_beyond_max_staleness_seqs():
    follower = _follower(LoopbackLink(), max_staleness_seqs=2)
    try:
        applier = follower._applier
        applier.stop()
        applier.apply_frames([SnapshotFrame(0, -1, -1, None, time.time())])
        applier.apply_frames([HeartbeatFrame(0, 4, time.time())])  # the primary is 5 records ahead
        assert follower.replica_lag().seqs_behind == 5
        with pytest.raises(StalenessExceeded):
            follower.compute("t0")
    finally:
        follower.close()


def test_seconds_behind_stays_unbounded_while_chewing_backlog():
    follower = _follower(LoopbackLink())
    try:
        applier = follower._applier
        applier.stop()
        now = time.time()
        applier.apply_frames([SnapshotFrame(0, -1, -1, None, now)])
        applier.apply_frames([HeartbeatFrame(0, 100, now)])
        key_bytes = pickle.dumps("t")
        payload = b"R" + struct.pack("<I", len(key_bytes)) + key_bytes + bytes((0,))
        applier.apply_frames([WalFrame(0, 0, payload, now)])
        assert applier.applied_seq == 0
        lag = applier.lag()
        assert lag.seqs_behind == 100 and lag.seconds_behind == float("inf")
    finally:
        follower.close()


def test_unbounded_staleness_always_serves(tmp_path):
    link = LoopbackLink()
    primary = _primary(tmp_path, link)
    follower = _follower(link)
    try:
        _feed(primary, seed=10, n=20)
        assert follower._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
        primary._shipper.close()
        time.sleep(0.2)
        follower.compute("t0")  # stale but served
    finally:
        primary.close(checkpoint=False)
        follower.close()


# --------------------------------------------------------------------------- config validation


def test_follower_with_checkpoint_refused(tmp_path):
    with pytest.raises(MetricsTPUUserError, match="promote_checkpoint"):
        StreamingEngine(_metric(), checkpoint=CheckpointConfig(directory=str(tmp_path)),
                        replication=ReplConfig(role="follower", transport=LoopbackLink()))


def test_primary_without_wal_refused(tmp_path):
    with pytest.raises(MetricsTPUUserError, match="wal"):
        StreamingEngine(_metric(), checkpoint=CheckpointConfig(directory=str(tmp_path), wal=False),
                        replication=ReplConfig(role="primary", transport=LoopbackLink()))


def test_primary_without_checkpoint_refused():
    with pytest.raises(MetricsTPUUserError, match="checkpoint"):
        StreamingEngine(_metric(), replication=ReplConfig(role="primary", transport=LoopbackLink()))


@pytest.mark.parametrize("kw,match", [
    ({"role": "leader"}, "role"),
    ({"transport": None}, "transport"),
    ({"ship_interval_s": 0}, "ship_interval_s"),
    ({"poll_interval_s": -1}, "poll_interval_s"),
    ({"heartbeat_interval_s": 0}, "heartbeat_interval_s"),
    ({"drain_timeout_s": -1.0}, "drain_timeout_s"),
    ({"max_staleness_seqs": -1}, "max_staleness_seqs"),
    ({"max_staleness_s": -0.5}, "max_staleness_s"),
    ({"epoch": -1}, "epoch"),
])
def test_config_validation_matches_jax(kw, match):
    base = {"role": "follower", "transport": LoopbackLink()}
    jbase = {"role": "follower", "transport": jrepl.LoopbackLink()}
    with pytest.raises(ValueError, match=match) as port_err:
        ReplConfig(**{**base, **kw})
    with pytest.raises(ValueError) as jax_err:
        JaxReplConfig(**{**jbase, **kw})
    assert str(port_err.value) == str(jax_err.value)


def test_replica_lag_bounds():
    lag = ReplicaLag(seqs_behind=3, seconds_behind=0.5)
    assert not lag.exceeds(None, None) and not lag.exceeds(3, 0.5)
    assert lag.exceeds(2, None) and lag.exceeds(None, 0.4)
