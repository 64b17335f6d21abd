"""The port's hot failover (``StreamingEngine.promote``/``demote`` and
``repl.failover_hook``) against the JAX package's, on the CPU: the twins of
``tests/repl/test_failover.py`` and ``tests/repl/test_not_promotable.py``.

A promotion drains the shipped tail, fences the link at a new epoch and flips
the follower writable; a zombie primary's later shipments are rejected; the
promoted lineage recovers in either package; an unbootstrapped follower refuses
with the retryable ``NotPromotableError``; a guard quarantine promotes through
``failover_hook``; ``demote()`` steps a primary down and re-attaches it as a
follower. Every wait is bounded.
"""

import threading
import time

import numpy as np
import pytest
import torch

import metrics_tpu.classification as jcls
from metrics_tpu.engine import CheckpointConfig as JaxCheckpointConfig
from metrics_tpu.engine import StreamingEngine as JaxEngine
from metrics_tpu_torch.aggregation import SumMetric
from metrics_tpu_torch.classification import BinaryAccuracy
from metrics_tpu_torch.engine import (
    CheckpointConfig,
    EngineQuarantined,
    GuardConfig,
    NotPrimaryError,
    ReplConfig,
    StreamingEngine,
)
from metrics_tpu_torch.guard.faults import hold_dispatch_lock, wedge_dispatcher
from metrics_tpu_torch.repl import (
    FlakyLink,
    LoopbackLink,
    NotPromotableError,
    SnapshotFrame,
    StallLink,
    WalFrame,
    failover_hook,
)
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

from tests.test_torch_engine import assert_trees_match, engine_states
from tests.test_torch_repl_follower import _wait, assert_states_equal

WAIT_S = 20


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _metric():
    return BinaryAccuracy(device="cpu")


def _pair(tmp_path, link=None, guard=None, ship_faults=None, **fkw):
    link = link if link is not None else LoopbackLink()
    transport = ship_faults(link) if ship_faults is not None else link
    primary = StreamingEngine(
        _metric(), buckets=(8, 32), guard=guard,
        checkpoint=CheckpointConfig(directory=str(tmp_path / "primary"), interval_s=0.05, durable=False),
        replication=ReplConfig(role="primary", transport=transport, ship_interval_s=0.01, heartbeat_interval_s=0.05),
    )
    follower = StreamingEngine(
        _metric(), buckets=(8, 32),
        replication=ReplConfig(
            role="follower", transport=link, poll_interval_s=0.01,
            promote_checkpoint=CheckpointConfig(directory=str(tmp_path / "follower"), interval_s=0.1, durable=False),
            **fkw,
        ),
    )
    return primary, follower


def _feed(engine, seed, n=60, keys=4):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        rows = int(rng.integers(1, 7))
        engine.submit(f"t{rng.integers(0, keys)}", rng.integers(0, 2, rows).astype(np.int32),
                      rng.integers(0, 2, rows).astype(np.int32))
    engine.flush(timeout=WAIT_S)


def _empty_bootstrap(follower):
    follower._applier.apply_frames([SnapshotFrame(0, -1, -1, None, time.time())])


def _one(key="t0"):
    return key, np.array([1], np.int32), np.array([1], np.int32)


# --------------------------------------------------------------------------- promotion


def test_promote_drains_flips_writable_and_fences(tmp_path):
    primary, follower = _pair(tmp_path)
    try:
        _feed(primary, seed=1)
        acked_seq = primary._wal_seq
        # wait for the SHIPPER, not the applier: the frames still in the link are
        # what promote()'s drain must pick up
        assert _wait(lambda: primary._shipper.last_shipped_seq >= acked_seq)
        want = engine_states(primary)
        follower.promote()
        assert follower._applier.applied_seq == acked_seq
        for key, state in want.items():
            assert_trees_match(follower._keyed.state_of(key), state, key)
        health = follower.health()["replication"]
        assert health["role"] == "primary" and follower._repl_epoch == 1 and follower.replica_lag() is None
        assert follower._repl_cfg.transport.fenced_epoch == 1
        assert follower.submit(*_one()).result(timeout=WAIT_S)["rows"] == 1
        assert follower.wal_watermark()[0] == 1
    finally:
        primary.close(checkpoint=False)
        follower.close()


def test_straggler_apply_after_promotion_is_a_noop(tmp_path):
    import pickle

    from metrics_tpu_torch.engine.runtime import _encode_request_record

    primary, follower = _pair(tmp_path)
    try:
        _feed(primary, seed=12)
        assert follower._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
        follower.promote()
        applier = follower._applier
        applied = applier.applied_seq
        payload = _encode_request_record(pickle.dumps("straggler"),
                                         (np.asarray([1], np.int32), np.asarray([1], np.int32)))
        applier.apply_frames([WalFrame(applier.epoch, applied + 1, payload, time.time())])
        assert applier.applied_seq == applied and "straggler" not in set(follower._keyed.keys)
    finally:
        primary.close(checkpoint=False)
        follower.close()


def test_promote_is_idempotent(tmp_path):
    primary, follower = _pair(tmp_path)
    try:
        assert _wait(lambda: follower._applier.bootstrapped)
        follower.promote()
        follower.promote()  # a no-op, no error
        assert follower.telemetry_snapshot()["promotions"] == 1
    finally:
        primary.close(checkpoint=False)
        follower.close()


def test_promote_on_non_follower_refused(tmp_path):
    primary, follower = _pair(tmp_path)
    try:
        with pytest.raises(MetricsTPUUserError):
            primary.promote()
        with pytest.raises(MetricsTPUUserError, match="role='primary'"):
            follower.promote(ship=ReplConfig(role="follower", transport=LoopbackLink()))
    finally:
        primary.close(checkpoint=False)
        follower.close()


def test_zombie_primary_shipments_rejected_after_fencing(tmp_path):
    primary, follower = _pair(tmp_path)
    try:
        _feed(primary, seed=2)
        assert follower._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
        follower.promote()
        promoted = engine_states(follower)
        _feed(primary, seed=3, n=30)  # the deposed primary keeps writing
        assert _wait(lambda: primary._shipper.fenced, timeout_s=5)
        assert primary.health()["state"] == "DEGRADED"  # split-brain surfaced
        assert primary.health()["replication"]["fenced"]
        assert primary.telemetry_snapshot()["fenced_rejections"] == 1
        for key, state in promoted.items():
            assert_trees_match(follower._keyed.state_of(key), state, key)
    finally:
        primary.close(checkpoint=False)
        follower.close()


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_promoted_lineage_survives_restart(reader, tmp_path):
    """The promoted node's own lineage (pin snapshot + new WAL) recovers in the
    port and in the JAX engine."""
    primary, follower = _pair(tmp_path)
    try:
        _feed(primary, seed=4)
        assert follower._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
        follower.promote()
        _feed(follower, seed=5, n=30)  # writes into the NEW lineage
        final = engine_states(follower)
        follower.close(checkpoint=False)  # crash: the new WAL carries the tail
        directory = str(tmp_path / "follower")
        if reader == "port":
            recovered = StreamingEngine(_metric(), buckets=(8, 32), start=False,
                                        checkpoint=CheckpointConfig(directory=directory, durable=False))
        else:
            recovered = JaxEngine(jcls.BinaryAccuracy(), buckets=(8, 32), start=False,
                                  checkpoint=JaxCheckpointConfig(directory=directory, durable=False))
        try:
            assert set(recovered._keyed.keys) == set(final)
            for key, want in final.items():
                assert_trees_match(want, recovered._keyed.state_of(key), key)
        finally:
            recovered.close(checkpoint=False)
    finally:
        primary.close(checkpoint=False)


def test_promote_refuses_unbootstrapped_follower():
    follower = StreamingEngine(_metric(), buckets=(8, 32),
                               replication=ReplConfig(role="follower", transport=LoopbackLink(), poll_interval_s=0.01))
    try:
        with pytest.raises(NotPromotableError, match="never bootstrapped"):
            follower.promote()
        assert issubclass(NotPromotableError, MetricsTPUUserError)
        assert follower._repl_follower and follower._applier is not None  # left intact
        _empty_bootstrap(follower)  # an EMPTY-bootstrap replica is promotable
        with pytest.warns(RuntimeWarning, match="WITHOUT durability"):  # no promote_checkpoint
            follower.promote()
        assert not follower._repl_follower
    finally:
        follower.close()


def test_promote_survives_unopenable_lineage_directory(tmp_path):
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("a file where the lineage directory must go")
    follower = StreamingEngine(_metric(), buckets=(8, 32), replication=ReplConfig(
        role="follower", transport=LoopbackLink(), poll_interval_s=0.01,
        promote_checkpoint=CheckpointConfig(directory=str(blocker), durable=False)))
    try:
        _empty_bootstrap(follower)
        with pytest.warns(RuntimeWarning, match="WITHOUT durability"):
            follower.promote()
        assert not follower._repl_follower
        follower.submit(*_one()).result(timeout=WAIT_S)  # writable and draining
        assert float(follower.compute("t0")) == 1.0
    finally:
        follower.close()


def test_repromotion_onto_stale_lineage_directory_recovers_cleanly(tmp_path):
    lineage = str(tmp_path / "promo")
    dead = StreamingEngine(_metric(), buckets=(8, 32),
                           checkpoint=CheckpointConfig(directory=lineage, interval_s=3600.0, durable=False))
    _feed(dead, seed=95, n=12)
    dead.checkpoint_now()
    _feed(dead, seed=96, n=6)  # leftovers: a generation and post-snapshot WAL
    dead.close(checkpoint=False)
    link = LoopbackLink()
    primary = StreamingEngine(_metric(), buckets=(8, 32), checkpoint=CheckpointConfig(
        directory=str(tmp_path / "primary"), interval_s=0.05, durable=False),
        replication=ReplConfig(role="primary", transport=link, ship_interval_s=0.01, heartbeat_interval_s=0.05))
    follower = StreamingEngine(_metric(), buckets=(8, 32), replication=ReplConfig(
        role="follower", transport=link, poll_interval_s=0.01,
        promote_checkpoint=CheckpointConfig(directory=lineage, interval_s=3600.0, durable=False)))
    try:
        _feed(primary, seed=97, n=30)
        assert follower._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
        primary.close(checkpoint=False)
        follower.promote()
        _feed(follower, seed=98, n=10)
        final = engine_states(follower)
        follower.close(checkpoint=False)
        recovered = StreamingEngine(_metric(), buckets=(8, 32), start=False,
                                    checkpoint=CheckpointConfig(directory=lineage, durable=False))
        try:
            assert set(recovered._keyed.keys) == set(final)
            for key, want in final.items():
                assert_trees_match(recovered._keyed.state_of(key), want, key)
        finally:
            recovered.close(checkpoint=False)
    finally:
        primary.close(checkpoint=False)
        follower.close()


def test_restarted_promoted_primary_recovers_its_epoch(tmp_path):
    primary, follower = _pair(tmp_path)
    try:
        _feed(primary, seed=9)
        assert follower._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
        link = follower._repl_cfg.transport
        follower.promote()
        follower.close(checkpoint=False)
    finally:
        primary.close(checkpoint=False)
    restarted = StreamingEngine(_metric(), buckets=(8, 32), checkpoint=CheckpointConfig(
        directory=str(tmp_path / "follower"), durable=False),
        replication=ReplConfig(role="primary", transport=link, ship_interval_s=0.01, heartbeat_interval_s=0.05))
    try:
        # the meta hands back epoch 1 and the resume bump passes it
        assert restarted._repl_epoch == 2 and restarted._shipper.epoch == 2
        _feed(restarted, seed=10, n=20)
        assert _wait(lambda: restarted._shipper.fenced or restarted._shipper.last_shipped_seq >= restarted._wal_seq)
        assert not restarted._shipper.fenced and restarted._shipper.last_shipped_seq >= 0
    finally:
        restarted.close(checkpoint=False)


def test_promote_epoch_override_and_a_stale_one_refused(tmp_path):
    primary, follower = _pair(tmp_path)
    try:
        assert _wait(lambda: follower._applier.bootstrapped)
        with pytest.raises(MetricsTPUUserError, match="must exceed"):
            follower.promote(epoch=0)
        assert follower._repl_follower
        follower.promote(epoch=7)
        assert follower._repl_epoch == 7 and follower._repl_cfg.transport.fenced_epoch == 7
    finally:
        primary.close(checkpoint=False)
        follower.close()


def test_promote_with_ship_reships_the_new_lineage(tmp_path):
    primary, follower = _pair(tmp_path)
    second_link = LoopbackLink()
    second = StreamingEngine(_metric(), buckets=(8, 32),
                             replication=ReplConfig(role="follower", transport=second_link, poll_interval_s=0.01))
    try:
        _feed(primary, seed=13)
        assert follower._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
        primary.close(checkpoint=False)
        follower.promote(ship=ReplConfig(role="primary", transport=second_link, ship_interval_s=0.01,
                                         heartbeat_interval_s=0.05))
        _feed(follower, seed=14, n=20)
        assert second._applier.await_seq(follower._wal_seq, timeout_s=WAIT_S)
        assert second._applier.epoch == 1
        assert_states_equal(follower, second)
    finally:
        primary.close(checkpoint=False)
        second.close()
        follower.close()


def test_promotion_under_flaky_ship_link(tmp_path):
    primary, follower = _pair(tmp_path, ship_faults=lambda inner: FlakyLink(inner, fail=3))
    try:
        _feed(primary, seed=6)
        assert follower._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
        follower.promote()
        assert follower._applier.applied_seq == primary._wal_seq
    finally:
        primary.close(checkpoint=False)
        follower.close()


def test_promotion_under_stalled_ship_link(tmp_path):
    primary, follower = _pair(tmp_path, ship_faults=lambda inner: StallLink(inner, 0.05, stalls=4))
    try:
        _feed(primary, seed=7)
        assert follower._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
        follower.promote()
        assert follower._applier.applied_seq == primary._wal_seq
    finally:
        primary.close(checkpoint=False)
        follower.close()


def test_promotion_steps_are_spans_with_obs_on(tmp_path):
    from metrics_tpu_torch import obs

    obs.reset()
    primary, follower = _pair(tmp_path)
    try:
        _feed(primary, seed=15, n=20)
        assert follower._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
        obs.enable()
        follower.promote()
        spans = {s["name"]: s for s in obs.TRACER.spans() if s["name"].startswith("repl.")}
        assert set(spans) == {"repl.promote", "repl.drain", "repl.fence", "repl.pin"}
        assert all(spans[n]["parent"] == "repl.promote" for n in ("repl.drain", "repl.fence", "repl.pin"))
        assert obs.instrument.REPL_PROMOTIONS.value(engine=follower.telemetry.engine_id) == 1
    finally:
        obs.reset()
        primary.close(checkpoint=False)
        follower.close()


# --------------------------------------------------------------------------- the guard's failover


def test_quarantine_transition_promotes_follower(tmp_path):
    link = LoopbackLink()
    follower = StreamingEngine(_metric(), buckets=(8, 32), replication=ReplConfig(
        role="follower", transport=link, poll_interval_s=0.01,
        promote_checkpoint=CheckpointConfig(directory=str(tmp_path / "follower"), interval_s=0.1, durable=False)))
    guard = GuardConfig(watchdog_timeout_s=0.2, watchdog_poll_s=0.02, hang_lock_timeout_s=0.2,
                        on_health_transition=failover_hook(follower))
    primary = StreamingEngine(
        _metric(), buckets=(8, 32), guard=guard,
        checkpoint=CheckpointConfig(directory=str(tmp_path / "p2"), interval_s=0.05, durable=False),
        replication=ReplConfig(role="primary", transport=link, ship_interval_s=0.01, heartbeat_interval_s=0.05))
    try:
        _feed(primary, seed=8)
        assert follower._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
        # wedge the dispatcher holding the dispatch lock: the watchdog's probe
        # fails, the engine quarantines, the hook fires
        with hold_dispatch_lock(primary), wedge_dispatcher(primary):
            try:
                primary.submit(*_one())
            except EngineQuarantined:
                pass  # the watchdog beat the submit: the goal state
            assert _wait(lambda: primary.quarantined, timeout_s=10)
        # the role flips inside promote(), which counts itself once it returns
        assert _wait(lambda: follower.telemetry_snapshot()["promotions"] == 1, timeout_s=10)
        assert follower.health()["replication"]["role"] == "primary"
        follower.submit(*_one("t1")).result(timeout=WAIT_S)
        with pytest.raises(EngineQuarantined):
            primary.submit(*_one())
    finally:
        primary.close(checkpoint=False)
        follower.close()


def _sum_follower(link, tmp_path):
    return StreamingEngine(SumMetric(device="cpu"), replication=ReplConfig(
        role="follower", transport=link, poll_interval_s=0.01,
        promote_checkpoint=CheckpointConfig(directory=str(tmp_path / "promoted"))))


def _sum_primary(link, tmp_path):
    return StreamingEngine(SumMetric(device="cpu"),
                           checkpoint=CheckpointConfig(directory=str(tmp_path / "primary"), wal_flush="fsync"),
                           replication=ReplConfig(role="primary", transport=link, ship_interval_s=0.01))


def test_unbootstrapped_promote_raises_dedicated_retryable_error(tmp_path):
    follower = _sum_follower(LoopbackLink(), tmp_path)
    try:
        with pytest.raises(NotPromotableError):
            follower.promote()
        assert follower._repl_follower and follower._applier is not None
    finally:
        follower.close()


def test_hook_retries_until_bootstrap_lands_then_promotes(tmp_path):
    link = LoopbackLink()
    follower = _sum_follower(link, tmp_path)
    primary = None
    hook = failover_hook(follower, retries=200, backoff_s=0.01, backoff_cap_s=0.05)
    try:
        worker = threading.Thread(target=hook, args=("SERVING", "QUARANTINED"))
        worker.start()
        time.sleep(0.1)  # a few refused attempts happen first
        assert follower._repl_follower
        primary = _sum_primary(link, tmp_path)  # its bootstrap snapshot unblocks the hook
        worker.join(timeout=WAIT_S)
        assert not worker.is_alive() and not follower._repl_follower
        follower.submit("k", np.array([5.0], np.float32)).result(timeout=WAIT_S)
        assert float(follower.compute("k")) == 5.0
    finally:
        if primary is not None:
            primary.close()
        follower.close()


def test_hook_gives_up_quietly_when_retries_exhausted(tmp_path):
    follower = _sum_follower(LoopbackLink(), tmp_path)
    try:
        failover_hook(follower, retries=3, backoff_s=0.001)("SERVING", "QUARANTINED")  # must not raise
        assert follower._repl_follower
    finally:
        follower.close()


def test_hook_fires_only_on_the_configured_edge(tmp_path):
    follower = _sum_follower(LoopbackLink(), tmp_path)
    hook = failover_hook(follower, retries=0)
    try:
        hook("SERVING", "DEGRADED")
        hook("QUARANTINED", "QUARANTINED")
        assert follower._repl_follower
    finally:
        follower.close()


# --------------------------------------------------------------------------- demotion


def test_demote_refuses_writes_then_reattaches_as_a_follower(tmp_path):
    """A deposed primary steps down (acked work drained into its lineage, the
    shipper's final publish made), then follows the promoted node's new link
    and bootstraps from its lineage."""
    primary, follower = _pair(tmp_path)
    new_link = LoopbackLink()
    try:
        _feed(primary, seed=16, n=30)
        assert follower._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
        primary.demote()  # parked read-only and unattached
        with pytest.raises(NotPrimaryError):
            primary.submit(*_one())
        assert primary._worker is None and primary._journal is None and primary._shipper is None
        assert primary.telemetry_snapshot()["demotions"] == 1
        with pytest.raises(MetricsTPUUserError, match="requires replication"):
            primary.promote()  # a demoted primary never followed anything
        follower.promote(ship=ReplConfig(role="primary", transport=new_link, ship_interval_s=0.01,
                                         heartbeat_interval_s=0.05))
        _feed(follower, seed=17, n=20)
        primary.demote(ReplConfig(role="follower", transport=new_link, poll_interval_s=0.01))
        assert primary._repl_follower and primary.health()["replication"]["role"] == "follower"
        assert primary._applier.await_seq(follower._wal_seq, timeout_s=WAIT_S)
        assert primary._applier.epoch == 1
        assert_states_equal(follower, primary)
        assert primary.telemetry_snapshot()["demotions"] == 2
        primary.demote()  # on a follower only the link goes: parked unattached
        assert primary._applier is None and primary.telemetry_snapshot()["demotions"] == 3
        with pytest.raises(NotPromotableError, match="unattached"):
            primary.promote()
    finally:
        primary.close(checkpoint=False)
        follower.close()


def test_demote_refuses_a_primary_config(tmp_path):
    primary, follower = _pair(tmp_path)
    try:
        with pytest.raises(MetricsTPUUserError, match="role='follower'"):
            primary.demote(ReplConfig(role="primary", transport=LoopbackLink()))
        assert not primary._repl_follower
    finally:
        primary.close(checkpoint=False)
        follower.close()
