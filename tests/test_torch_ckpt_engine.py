"""The port's StreamingEngine durable state plane (``metrics_tpu_torch/engine/runtime.py``
with ``checkpoint=CheckpointConfig(...)``) against the JAX package's, on the CPU.

One counterpart for each test of ``tests/ckpt/test_engine_ckpt.py`` and of the
engine half of ``tests/ckpt/test_wal_fsync.py``, run on the port (the 10k-request
restart soak stays ``slow``). Then the directories in both directions: a JAX
engine journals, takes a snapshot and is closed with ``checkpoint=False``, and a
port engine (``device="cpu"``) recovers from that directory; and the reverse. The
families are ``BinaryAccuracy``, ``MeanSquaredError``, the flagship
``MulticlassAccuracy`` and ``MulticlassConfusionMatrix`` (alone and in the
flagship collection), a windowed engine, an inline (eager-path) writer and an
evicted tenant (the ``T`` record). States must match leaf for leaf
(``assert_trees_match``: integer states bit for bit with their dtype, float
states within rtol 1e-6). Tiered engines cross too: a directory whose WAL holds
demote and promote records (``D``, ``P``) and whose snapshot carries a ``tier``
section (warm entries by value, cold tenants by spill file), written by either
package, recovers in the other. The JAX package's trace trailers are read past.
"""

import pickle
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.classification as jcls
import metrics_tpu_torch as tm
import metrics_tpu_torch.classification as tcls
from metrics_tpu.ckpt import RequestJournal as JaxJournal
from metrics_tpu.engine import CheckpointConfig as JaxCheckpointConfig
from metrics_tpu.engine import StreamingEngine as JaxEngine
from metrics_tpu.engine import runtime as jax_runtime
from metrics_tpu.obs.context import TraceContext
from metrics_tpu_torch.ckpt import SnapshotStore, loads
from metrics_tpu_torch.ckpt.faults import flip_bit
from metrics_tpu_torch.classification import BinaryAccuracy, BinaryAUROC
from metrics_tpu_torch.engine import CheckpointConfig, EngineClosed, StreamingEngine
from metrics_tpu_torch.regression import MeanSquaredError
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from tests.test_torch_engine import (  # noqa: F401  (_one_torch_thread: the autouse fixture)
    WAIT_S,
    _one_torch_thread,
    assert_trees_match,
    fold_rows,
)

CPU = {"device": "cpu"}


def _stream(seed, n, keys=4, rows=4, float_data=False):
    rng = np.random.default_rng(seed)
    draw = (lambda: rng.random(rows, dtype=np.float32)) if float_data else (lambda: rng.integers(0, 2, rows))
    return [(f"k{rng.integers(0, keys)}", draw(), draw()) for _ in range(n)]


def _oracles(stream, factory):
    oracles = {}
    for key, p, t in stream:
        oracles.setdefault(key, factory()).update(torch.from_numpy(p), torch.from_numpy(t))
    return oracles


def _cfg(tmp_path, **kw):
    kw.setdefault("interval_s", 3600.0)  # periodic off unless the test wants it
    kw.setdefault("durable", False)
    return CheckpointConfig(directory=str(tmp_path), **kw)


def _submit(engine, stream):
    for key, p, t in stream:
        engine.submit(key, p, t)
    engine.flush(timeout=WAIT_S)


# --------------------------------------------------------------------------- tests/ckpt/test_engine_ckpt.py


class TestSnapshotAndRecover:
    def test_restart_recovers_snapshot_plus_wal_exactly_once(self, tmp_path):
        stream = _stream(0, 300)
        cfg = _cfg(tmp_path)
        e1 = StreamingEngine(BinaryAccuracy(**CPU), buckets=(8, 32), checkpoint=cfg)
        _submit(e1, stream[:120])
        assert e1.checkpoint_now() == 0  # the snapshot covers the first 120
        _submit(e1, stream[120:200])  # these live only in the WAL
        e1.close(checkpoint=False)  # crash-style: no final snapshot

        e2 = StreamingEngine(BinaryAccuracy(**CPU), buckets=(8, 32), checkpoint=cfg)
        try:
            snap = e2.telemetry_snapshot()
            assert snap["recoveries"] == 1 and snap["replayed"] >= 1 and snap["failed"] == 0
            _submit(e2, stream[200:])
            for key, oracle in _oracles(stream, lambda: BinaryAccuracy(**CPU)).items():
                assert float(e2.compute(key)) == float(oracle.compute()), key
        finally:
            e2.close()

    def test_new_tenant_after_recovery_gets_a_fresh_slot(self, tmp_path):
        cfg = _cfg(tmp_path)
        e1 = StreamingEngine(BinaryAccuracy(**CPU), buckets=(8,), checkpoint=cfg)
        stream = _stream(7, 80, keys=3)
        _submit(e1, stream)
        e1.checkpoint_now()
        e1.close(checkpoint=False)

        e2 = StreamingEngine(BinaryAccuracy(**CPU), buckets=(8,), checkpoint=cfg)
        try:
            e2.submit("brand-new", np.array([1, 1, 0, 0]), np.array([1, 0, 0, 1]))
            e2.flush(timeout=WAIT_S)
            slots = e2._keyed._slots
            assert len(set(slots.values())) == len(slots), "slot id collision after recovery"
            for key, oracle in _oracles(stream, lambda: BinaryAccuracy(**CPU)).items():
                assert float(e2.compute(key)) == float(oracle.compute()), key
            assert float(e2.compute("brand-new")) == 0.5
        finally:
            e2.close()

    def test_periodic_snapshots_land_without_explicit_calls(self, tmp_path):
        engine = StreamingEngine(BinaryAccuracy(**CPU), buckets=(8,), checkpoint=_cfg(tmp_path, interval_s=0.01))
        try:
            for key, p, t in _stream(1, 150):
                engine.submit(key, p, t)
                time.sleep(0.0005)
            engine.flush(timeout=WAIT_S)
            assert engine._ckpt_writer.quiesce(timeout=WAIT_S)
            snap = engine.telemetry_snapshot()
            assert snap["checkpoints"] >= 1
            assert snap["wal_records"] >= 1  # chunk records, one per dispatched micro-batch
        finally:
            engine.close()

    def test_clean_close_needs_no_replay(self, tmp_path):
        stream = _stream(2, 200)
        cfg = _cfg(tmp_path)
        e1 = StreamingEngine(BinaryAccuracy(**CPU), buckets=(8, 32), checkpoint=cfg)
        _submit(e1, stream)
        e1.close()  # final snapshot + WAL rotation
        e2 = StreamingEngine(BinaryAccuracy(**CPU), buckets=(8, 32), checkpoint=cfg)
        try:
            snap = e2.telemetry_snapshot()
            assert snap["recoveries"] == 1 and snap["replayed"] == 0
            for key, oracle in _oracles(stream, lambda: BinaryAccuracy(**CPU)).items():
                assert float(e2.compute(key)) == float(oracle.compute())
        finally:
            e2.close()

    def test_corrupt_newest_generation_falls_back(self, tmp_path):
        stream = _stream(3, 200)
        cfg = _cfg(tmp_path, wal=False)  # isolate snapshot fallback
        e1 = StreamingEngine(BinaryAccuracy(**CPU), buckets=(8, 32), checkpoint=cfg)
        _submit(e1, stream[:100])
        e1.checkpoint_now()
        _submit(e1, stream[100:])
        gen2 = e1.checkpoint_now()
        e1.close(checkpoint=False)
        flip_bit(e1._ckpt_store.path(gen2))
        with pytest.warns(RuntimeWarning, match="recovered from an older generation"):
            e2 = StreamingEngine(BinaryAccuracy(**CPU), buckets=(8, 32), checkpoint=cfg)
        try:
            assert e2.telemetry_snapshot()["recoveries"] == 1
            for key, oracle in _oracles(stream[:100], lambda: BinaryAccuracy(**CPU)).items():
                assert float(e2.compute(key)) == float(oracle.compute())
        finally:
            e2.close()

    def test_no_snapshot_no_wal_starts_fresh(self, tmp_path):
        engine = StreamingEngine(BinaryAccuracy(**CPU), buckets=(8,), checkpoint=_cfg(tmp_path))
        try:
            assert engine.telemetry_snapshot()["recoveries"] == 0
            assert engine._keyed.keys == ()
            assert engine.wal_watermark() == (0, -1)
        finally:
            engine.close()


class TestModesAndShapes:
    def test_eager_metric_checkpoints_too(self, tmp_path):
        rng = np.random.default_rng(4)
        stream = [(f"k{rng.integers(0, 3)}", rng.random(4, dtype=np.float32), rng.integers(0, 2, 4))
                  for _ in range(60)]
        cfg = _cfg(tmp_path)
        e1 = StreamingEngine(BinaryAUROC(thresholds=None, **CPU), buckets=(8,), checkpoint=cfg)
        assert not e1.fused
        _submit(e1, stream[:40])
        e1.checkpoint_now()
        _submit(e1, stream[40:])
        e1.close(checkpoint=False)
        e2 = StreamingEngine(BinaryAUROC(thresholds=None, **CPU), buckets=(8,), checkpoint=cfg)
        try:
            assert e2.telemetry_snapshot()["replayed"] == 20
            for key, oracle in _oracles(stream, lambda: BinaryAUROC(thresholds=None, **CPU)).items():
                assert float(e2.compute(key)) == float(oracle.compute()), key
        finally:
            e2.close()

    def test_float_states_restore_bit_identical(self, tmp_path):
        """Float sums depend on accumulation order, so the bit-identity claim is
        against an UNINTERRUPTED engine fed the same stream."""
        stream = _stream(5, 200, float_data=True)
        cfg = _cfg(tmp_path)
        e1 = StreamingEngine(MeanSquaredError(**CPU), buckets=(8, 32), checkpoint=cfg)
        twin = StreamingEngine(MeanSquaredError(**CPU), buckets=(8, 32))
        try:
            for i, (key, p, t) in enumerate(stream):
                e1.submit(key, p, t)
                twin.submit(key, p, t)
                if i == 120:
                    e1.checkpoint_now()  # the tail rides the WAL -> replay path
            e1.flush(timeout=WAIT_S)
            e1.close(checkpoint=False)
            twin.flush(timeout=WAIT_S)
            e2 = StreamingEngine(MeanSquaredError(**CPU), buckets=(8, 32), checkpoint=cfg)
            try:
                assert e2.telemetry_snapshot()["replayed"] >= 1
                for key in {k for k, _, _ in stream}:
                    assert torch.equal(e2.compute(key), twin.compute(key)), key
            finally:
                e2.close()
        finally:
            twin.close()

    def test_windowed_engine_restores_ring(self, tmp_path):
        stream = _stream(6, 120)
        cfg = _cfg(tmp_path)
        e1 = StreamingEngine(BinaryAccuracy(**CPU), buckets=(8,), window=3, checkpoint=cfg)
        again = StreamingEngine(BinaryAccuracy(**CPU), buckets=(8,), window=3)
        try:
            for engine in (e1, again):
                for i, (key, p, t) in enumerate(stream):
                    engine.submit(key, p, t)
                    if i in (40, 80):
                        engine.rotate_window()
                engine.flush(timeout=WAIT_S)
            e1.close()
            e2 = StreamingEngine(BinaryAccuracy(**CPU), buckets=(8,), window=3, checkpoint=cfg)
            try:
                for key in {k for k, _, _ in stream}:
                    assert float(e2.compute(key, window=True)) == float(again.compute(key, window=True)), key
            finally:
                e2.close()
        finally:
            again.close()

    def test_schema_mismatch_snapshot_skipped(self, tmp_path):
        cfg = _cfg(tmp_path, wal=False)
        e1 = StreamingEngine(BinaryAccuracy(**CPU), buckets=(8,), checkpoint=cfg)
        _submit(e1, _stream(7, 100))
        e1.close()
        with pytest.warns(RuntimeWarning, match="NO valid generation remained"):
            e2 = StreamingEngine(MeanSquaredError(**CPU), buckets=(8,), checkpoint=cfg)
        assert e2.telemetry_snapshot()["recoveries"] == 0
        assert e2._ckpt_store.last_skipped  # it saw and rejected the snapshot
        e2.close(checkpoint=False)


class TestDegradedMode:
    def test_inline_submits_are_journaled(self, tmp_path):
        stream = _stream(8, 60)
        cfg = _cfg(tmp_path)
        engine = StreamingEngine(BinaryAccuracy(**CPU), buckets=(8,), checkpoint=cfg, start=False)
        for key, p, t in stream:  # no dispatcher: every submit runs inline
            engine.submit(key, p, t)
        snap = engine.telemetry_snapshot()
        assert snap["inline_dispatches"] == 60 and snap["wal_records"] == 60
        engine.close(checkpoint=False)
        e2 = StreamingEngine(BinaryAccuracy(**CPU), buckets=(8,), checkpoint=cfg)
        try:
            assert e2.telemetry_snapshot()["replayed"] == 60
            for key, oracle in _oracles(stream, lambda: BinaryAccuracy(**CPU)).items():
                assert float(e2.compute(key)) == float(oracle.compute())
        finally:
            e2.close()

    def test_a_journal_io_failure_disables_the_wal_and_serving_continues(self, tmp_path):
        engine = StreamingEngine(BinaryAccuracy(**CPU), buckets=(8,), checkpoint=_cfg(tmp_path))
        try:
            _submit(engine, _stream(9, 10))
            assert not engine.health()["wal_disabled"]

            def full(payloads):
                raise OSError(28, "No space left on device (injected)")

            engine._journal.append_many = full
            stream = _stream(10, 20)
            _submit(engine, stream)
            health = engine.health()
            assert health["wal_disabled"] and health["state"] == "DEGRADED"
            snap = engine.telemetry_snapshot()
            assert snap["checkpoint_failures"] == 1 and snap["processed"] == 30 and snap["failed"] == 0
            assert engine._journal is None
        finally:
            engine.close()


@pytest.mark.slow
class TestRestartSoak:
    def test_10k_stream_with_mid_stream_restart_bit_identical(self, tmp_path):
        stream = _stream(9, 10_000, keys=16)
        cfg = CheckpointConfig(directory=str(tmp_path), interval_s=0.05, durable=False)
        cut, tail = 6_000, 200
        e1 = StreamingEngine(BinaryAccuracy(**CPU), buckets=(16, 64), checkpoint=cfg)
        _submit(e1, stream[: cut - tail])
        deadline = time.monotonic() + 30
        while e1._ckpt_writer.writes == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert e1._ckpt_writer.writes >= 1
        # freeze periodic snapshots so the final stretch lives only in the WAL
        e1._ckpt_writer.interval_s = 1e9
        e1._ckpt_writer.quiesce(timeout=30)
        _submit(e1, stream[cut - tail : cut])
        e1.close(checkpoint=False)
        e2 = StreamingEngine(BinaryAccuracy(**CPU), buckets=(16, 64), checkpoint=cfg)
        try:
            s = e2.telemetry_snapshot()
            assert s["recoveries"] == 1 and s["replayed"] >= 1
            _submit(e2, stream[cut:])
            for key, oracle in _oracles(stream, lambda: BinaryAccuracy(**CPU)).items():
                assert float(e2.compute(key)) == float(oracle.compute()), key
        finally:
            e2.close()


# --------------------------------------------------------------------------- the engine half of tests/ckpt/test_wal_fsync.py


class TestEngineWalFsyncPolicy:
    def _engine(self, tmp_path, **ckpt_kw):
        return StreamingEngine(tm.SumMetric(**CPU),
                               checkpoint=CheckpointConfig(directory=str(tmp_path), interval_s=3600.0, **ckpt_kw))

    def test_commit_mode_syncs_every_append(self, tmp_path):
        eng = self._engine(tmp_path, wal_fsync="commit")
        try:
            eng.submit("k", np.array([1.0]))
            eng.flush(timeout=WAIT_S)
            j = eng._journal
            assert j.last_seq >= 0 and j.synced_seq == j.last_seq
        finally:
            eng.close()

    def test_never_mode_leaves_tail_unsynced(self, tmp_path):
        eng = self._engine(tmp_path, wal_fsync="never", wal_flush="flush")
        try:
            eng.submit("k", np.array([1.0]))
            eng.flush(timeout=WAIT_S)
            j = eng._journal
            assert j.last_seq >= 0 and j.synced_seq == -1
        finally:
            eng.close()

    def test_interval_mode_syncs_once_elapsed(self, tmp_path):
        eng = self._engine(tmp_path, wal_fsync="interval", wal_fsync_interval_s=1e-9)
        try:
            eng.submit("k", np.array([1.0]))
            eng.flush(timeout=WAIT_S)
            assert eng._journal.synced_seq == eng._journal.last_seq
        finally:
            eng.close()

    def test_invalid_policy_rejected(self, tmp_path):
        with pytest.raises(MetricsTPUUserError):
            self._engine(tmp_path, wal_fsync="always")

    def test_interval_mode_requires_positive_interval(self, tmp_path):
        with pytest.raises(MetricsTPUUserError):
            self._engine(tmp_path, wal_fsync="interval", wal_fsync_interval_s=0.0)


# --------------------------------------------------------------------------- the two packages


C = 6


def _labels(rng, rows):
    return rng.integers(0, C, rows).astype(np.int32), rng.integers(0, C, rows).astype(np.int32)


def _binary(rng, rows):
    return rng.integers(0, 2, rows).astype(np.int64), rng.integers(0, 2, rows).astype(np.int64)


def _floats(rng, rows):
    return rng.normal(size=rows).astype(np.float32), rng.normal(size=rows).astype(np.float32)


def _flagship(pkg, **kw):
    return pkg.MetricCollection({
        "accuracy": pkg.classification.MulticlassAccuracy(C, average="micro", **kw),
        "f1": pkg.classification.MulticlassF1Score(C, average="macro", **kw),
        "confmat": pkg.classification.MulticlassConfusionMatrix(C, **kw),
    })


# name -> (JAX metric, port metric, request generator, engine settings)
CROSS = {
    "binary_accuracy": (jcls.BinaryAccuracy, lambda: tcls.BinaryAccuracy(**CPU), _binary, {}),
    "mse": (jm.MeanSquaredError, lambda: tm.MeanSquaredError(**CPU), _floats, {}),
    "multiclass_accuracy": (lambda: jcls.MulticlassAccuracy(C, average="macro"),
                            lambda: tcls.MulticlassAccuracy(C, average="macro", **CPU), _labels, {}),
    "confmat": (lambda: jcls.MulticlassConfusionMatrix(C), lambda: tcls.MulticlassConfusionMatrix(C, **CPU),
                _labels, {}),
    "flagship": (lambda: _flagship(jm), lambda: _flagship(tm, **CPU), _labels, {}),
    "windowed": (jcls.BinaryAccuracy, lambda: tcls.BinaryAccuracy(**CPU), _binary, {"window": 3}),
    "inline": (jm.MeanSquaredError, lambda: tm.MeanSquaredError(**CPU), _floats, {"start": False}),
}


def _requests(gen, seed, n, keys=4):
    rng = np.random.default_rng(seed)
    return [(f"t{int(rng.integers(0, keys))}", gen(rng, int(rng.integers(1, 6)))) for _ in range(n)]


def _serve(engine, reqs, to_args, rotate_at=()):
    for i, (key, args) in enumerate(reqs):
        engine.submit(key, *to_args(args))
        if i in rotate_at:
            engine.rotate_window()
    engine.flush(timeout=WAIT_S)


def _live_states(engine, window):
    keyed = engine._keyed
    return {key: keyed.merged_state(key) if window else keyed.state_of(key) for key in keyed.keys}


@pytest.mark.parametrize("family", sorted(CROSS))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_directory_of_either_package_recovers_in_the_other(family, writer, tmp_path):
    """The writer serves, takes a snapshot, serves more (a window rotation and an
    eviction among it), and is closed without a final snapshot: the reader
    recovers the snapshot and replays the WAL's C, R, W and T records."""
    make_jax, make_port, gen, kw = CROSS[family]
    window = "window" in kw
    engine_kw = {"buckets": (8,), "capacity": 2, **kw}
    reqs = _requests(gen, seed=len(family), n=40)
    jax_args, port_args = (lambda a: tuple(map(jnp.asarray, a))), (lambda a: a)
    if writer == "jax":
        make_w, make_r, cfg_w, cfg_r, args_w = (
            make_jax, make_port, JaxCheckpointConfig, CheckpointConfig, jax_args)
        w_cls, r_cls = JaxEngine, StreamingEngine
    else:
        make_w, make_r, cfg_w, cfg_r, args_w = (
            make_port, make_jax, CheckpointConfig, JaxCheckpointConfig, port_args)
        w_cls, r_cls = StreamingEngine, JaxEngine
    w = w_cls(make_w(), checkpoint=cfg_w(directory=str(tmp_path), interval_s=3600.0, durable=False), **engine_kw)
    try:
        _serve(w, reqs[:15], args_w)
        assert w.checkpoint_now() == 0
        _serve(w, reqs[15:], args_w, rotate_at=(25,) if window else ())
        assert w.evict_tenant("t1") is True
        _serve(w, reqs[-3:], args_w)  # t1 may come back as a fresh tenant on a reused slot
        want = _live_states(w, window)
    finally:
        w.close(checkpoint=False)
    reader_kw = {k: v for k, v in engine_kw.items() if k != "start"}
    r = r_cls(make_r(), checkpoint=cfg_r(directory=str(tmp_path), interval_s=3600.0, durable=False), **reader_kw)
    try:
        snap = r.telemetry_snapshot()
        assert snap["recoveries"] == 1 and snap["replayed"] >= 1 and snap["failed"] == 0
        got = _live_states(r, window)
        assert set(got) == set(want)
        for key in want:
            port, ref = (got[key], want[key]) if writer == "jax" else (want[key], got[key])
            assert_trees_match(port, ref, f"{family} {key}")
    finally:
        r.close(checkpoint=False)


def _jax_journal(tmp_path, payloads):
    j = JaxJournal(str(tmp_path), durable=False)
    j.append_many(payloads)
    j.close()


@pytest.mark.parametrize("kind", [b"D", b"P", b"P-empty"])
def test_a_jax_tier_record_replays_as_in_jax(kind, tmp_path):
    """A JAX-written WAL with one tier record after some requests: the port's
    recovery ends where the JAX engine's does — a ``D`` parks the tenant warm
    with its captured row, a ``P`` installs the journaled slot and restores the
    embedded entry (an empty blob: a fresh row)."""
    key = pickle.dumps("t0")
    rng = np.random.default_rng(21)
    p, t = _binary(rng, 3)
    entry = {"state": {k: np.asarray(v) for k, v in jcls.BinaryAccuracy().update_state(
        jcls.BinaryAccuracy().init_state(), jnp.asarray(p), jnp.asarray(t)).items()}, "ring": [], "rot": 0}
    blob = b"" if kind == b"P-empty" else jax_runtime.ckpt_format.dumps(entry, meta={"kind": "tier-promote"})
    records = [jax_runtime._encode_request_record(key, (p, t)),
               jax_runtime._encode_tier_record(kind[:1], 3 if kind[:1] == b"P" else 0, pickle.dumps("t9")
                                               if kind[:1] == b"P" else key, blob)]
    _jax_journal(tmp_path, records)
    ref = JaxEngine(jcls.BinaryAccuracy(), buckets=(8,), checkpoint=JaxCheckpointConfig(
        directory=str(tmp_path), interval_s=3600.0, durable=False))
    ref_tiers = {k: ref.tenant_tier(k) for k in ("t0", "t9")}
    ref_states = {k: ref._keyed.state_of(k) for k in ref._keyed.keys}
    ref_warm = {k: v for k, v in (ref._tier.warm.items() if ref._tier is not None else ())}
    ref.close(checkpoint=False)
    engine = StreamingEngine(tcls.BinaryAccuracy(**CPU), buckets=(8,), checkpoint=_cfg(tmp_path))
    try:
        assert engine.telemetry_snapshot()["replayed"] == 2 and engine.telemetry_snapshot()["failed"] == 0
        assert {k: engine.tenant_tier(k) for k in ("t0", "t9")} == ref_tiers
        assert set(engine._keyed.keys) == set(ref_states)
        for k, state in ref_states.items():
            assert_trees_match(engine._keyed.state_of(k), state, k)
        for k, warm in ref_warm.items():
            assert_trees_match(engine._tier.warm[k], warm, k)
        if kind[:1] == b"P":
            assert engine._keyed._slots["t9"] == 3
            engine.submit("new", p, t).result(timeout=WAIT_S)
            assert engine._keyed._slots["new"] not in (engine._keyed._slots["t0"], 3)
    finally:
        engine.close(checkpoint=False)


def _tier_cfg(pkg_cfg, tmp_path, name):
    return pkg_cfg(hot_capacity=3, warm_capacity=2, spill_directory=str(tmp_path / name), idle_demote_s=1000.0,
                   check_interval_s=0.0)


@pytest.mark.parametrize("family", ["binary_accuracy", "flagship", "windowed"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_tiered_directory_of_either_package_recovers_in_the_other(family, writer, tmp_path):
    """A tiered writer (hot set 3, warm set 2, the rest spilled) serves 8
    tenants, takes a snapshot whose tier section holds warm and cold tenants,
    serves more (demotions, promotions, an eviction, a rotation), and crashes:
    the other package's engine recovers from the snapshot, the spill files and
    the WAL's D, P and T records, and every tenant — readmitted — holds the
    writer's state."""
    make_jax, make_port, gen, kw = CROSS[family]
    window = "window" in kw
    engine_kw = {"buckets": (8,), "capacity": 2, **kw}
    reqs = _requests(gen, seed=7 + len(family), n=60, keys=8)
    from metrics_tpu.engine import TierConfig as JaxTierConfig
    from metrics_tpu_torch.engine import TierConfig

    jax_args, port_args = (lambda a: tuple(map(jnp.asarray, a))), (lambda a: a)
    if writer == "jax":
        w = JaxEngine(make_jax(), checkpoint=JaxCheckpointConfig(directory=str(tmp_path / "ckpt"),
                                                                 interval_s=3600.0, durable=False),
                      tier=_tier_cfg(JaxTierConfig, tmp_path, "spill"), **engine_kw)
        args_w = jax_args
    else:
        w = StreamingEngine(make_port(), checkpoint=_cfg(tmp_path / "ckpt"),
                            tier=_tier_cfg(TierConfig, tmp_path, "spill"), **engine_kw)
        args_w = port_args

    def serve(chunk):
        for key, args in chunk:
            w.submit(key, *args_w(args))
            w.flush(timeout=WAIT_S)

    try:
        serve(reqs[:30])
        tiers = w.tier_stats()
        assert tiers["warm"] >= 1 and tiers["cold"] >= 1
        assert w.checkpoint_now() is not None
        serve(reqs[30:45])
        if window:
            w.rotate_window()
        assert w.evict_tenant(reqs[0][0]) is True
        serve(reqs[45:])
        keys = sorted(set(k for k, _ in reqs))
        want_tiers = {k: w.tenant_tier(k) for k in keys}
        assert {"hot", "warm", "cold"} <= set(want_tiers.values()) or len(keys) < 6
        assert w.telemetry_snapshot()["tier_promotions"] >= 1
        for k in keys:
            if want_tiers[k] is not None:
                w.pin_tenant(k)
        want = _live_states(w, window)
    finally:
        w.close(checkpoint=False)
    journal = JaxJournal(str(tmp_path / "ckpt"), durable=False)
    kinds = {payload[:1] for _, payload in journal.replay()}
    journal.close()
    assert {b"D", b"P", b"T"} <= kinds
    if writer == "jax":
        r = StreamingEngine(make_port(), checkpoint=_cfg(tmp_path / "ckpt"), **engine_kw)
    else:
        r = JaxEngine(make_jax(), checkpoint=JaxCheckpointConfig(directory=str(tmp_path / "ckpt"),
                                                                 interval_s=3600.0, durable=False), **engine_kw)
    try:
        snap = r.telemetry_snapshot()
        assert snap["recoveries"] == 1 and snap["replayed"] >= 1 and snap["failed"] == 0
        for k in keys:
            if want_tiers[k] is None:
                assert r.tenant_tier(k) is None
            else:
                r.pin_tenant(k)
        got = _live_states(r, window)
        assert set(got) == set(want)
        for key in want:
            port, ref = (got[key], want[key]) if writer == "jax" else (want[key], got[key])
            assert_trees_match(port, ref, f"{family} {key}")
    finally:
        r.close(checkpoint=False)


def test_trace_trailers_of_jax_records_are_read_past(tmp_path):
    """R and C records with the JAX package's trace-context trailer replay as
    the records without it."""
    rng = np.random.default_rng(13)
    ctx = TraceContext(0x1234, 0x5678)
    p, t = _labels(rng, 3)
    col_p, col_t = np.zeros((8, 1), np.int32), np.zeros((8, 1), np.int32)
    col_p[:3, 0], col_t[:3, 0] = p, t
    key_ids, mask = np.zeros(8, np.int32), np.arange(8) < 3
    chunk = jax_runtime._encode_chunk_record([(0, pickle.dumps("a"))], key_ids, mask, [col_p, col_t], [ctx, ctx])
    request = jax_runtime._encode_request_record(pickle.dumps("b"), (p, t), ctx)
    _jax_journal(tmp_path, [chunk, request])
    metric = tcls.MulticlassAccuracy(C, average="micro", **CPU)
    engine = StreamingEngine(metric, buckets=(8,), checkpoint=_cfg(tmp_path))
    try:
        assert engine.telemetry_snapshot()["replayed"] == 2 and engine.telemetry_snapshot()["failed"] == 0
        assert engine._keyed._slots == {"a": 0, "b": 1}
        assert_trees_match(engine._keyed.state_of("a"), fold_rows(metric, [("a", (p, t))])["a"])
        whole = metric.update_state(metric.init_state(), torch.from_numpy(p), torch.from_numpy(t))
        assert_trees_match(engine._keyed.state_of("b"), whole)
    finally:
        engine.close(checkpoint=False)


def test_snapshots_hold_numpy_and_python_only(tmp_path):
    """No tensor and no torch object reaches a snapshot: every array leaf is numpy
    with the state's dtype (int32 counts stay int32), and tenant keys that are not
    strings ride as plain pickled Python."""
    engine = StreamingEngine(_flagship(tm, **CPU), buckets=(8,), checkpoint=_cfg(tmp_path))
    try:
        rng = np.random.default_rng(14)
        for key in ("s", ("tuple", 1), 7):
            engine.submit(key, *_labels(rng, 4))
        engine.checkpoint_now()
    finally:
        engine.close(checkpoint=False)
    store = SnapshotStore(str(tmp_path), durable=False)
    blob = store.read(store.generations()[-1])
    assert b"torch" not in blob

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            assert isinstance(x, (np.ndarray, np.generic, str, int, float, type(None))), type(x)

    tree = loads(blob).tree
    walk(tree)
    assert tree["stacked"]["confmat"]["confmat"].dtype == np.int32
    assert tree["stacked"]["accuracy"]["_update_count"].dtype == np.int32
    assert set(tree["slots"]) == {"s", ("tuple", 1), 7}


def test_wal_watermark_follows_the_journal(tmp_path):
    engine = StreamingEngine(BinaryAccuracy(**CPU), buckets=(8,), checkpoint=_cfg(tmp_path))
    try:
        assert engine.wal_watermark() == (0, -1)
        _submit(engine, _stream(15, 5))
        epoch, seq = engine.wal_watermark()
        assert epoch == 0 and seq == engine._journal.last_seq >= 0
    finally:
        engine.close()
    with pytest.raises(EngineClosed):
        engine.wal_watermark()


def test_a_crash_after_a_clean_restart_loses_nothing(tmp_path):
    """A clean close takes a final snapshot, whose rotation deletes every WAL
    segment; the engine that restarts there numbers its records on from the
    snapshot's seq, so a crash after it replays them. (The JAX package numbers
    from 0 again and replays none: ROADMAP C.6.)"""
    stream = _stream(16, 90, keys=2)
    cfg = _cfg(tmp_path)
    e1 = StreamingEngine(BinaryAccuracy(**CPU), buckets=(8,), checkpoint=cfg)
    _submit(e1, stream[:30])
    e1.close()
    e2 = StreamingEngine(BinaryAccuracy(**CPU), buckets=(8,), checkpoint=cfg)
    assert e2._journal.last_seq == e2.wal_watermark()[1] >= 0
    _submit(e2, stream[30:60])
    e2.close(checkpoint=False)
    e3 = StreamingEngine(BinaryAccuracy(**CPU), buckets=(8,), checkpoint=cfg)
    try:
        assert e3.telemetry_snapshot()["replayed"] >= 1
        _submit(e3, stream[60:])
        for key, oracle in _oracles(stream, lambda: BinaryAccuracy(**CPU)).items():
            assert float(e3.compute(key)) == float(oracle.compute()), key
    finally:
        e3.close()


def _chunk_for(slot_keys, rows, bucket=8):
    """One C record of binary rows for ``slot_keys`` (slot -> key), padded to ``bucket``."""
    preds, target = np.zeros((bucket, 1), np.float32), np.zeros((bucket, 1), np.int32)
    key_ids, mask = np.zeros(bucket, np.int32), np.zeros(bucket, bool)
    for i, (slot, p, t) in enumerate(rows):
        preds[i, 0], target[i, 0], key_ids[i], mask[i] = p, t, slot, True
    intro = [(slot, pickle.dumps(key)) for slot, key in slot_keys.items()]
    return jax_runtime._encode_chunk_record(intro, key_ids, mask, [preds, target])


@pytest.mark.parametrize("route", ["per_row_walk", "eager_engine"])
def test_a_chunk_that_cannot_replay_through_a_graph_walks_its_rows(route, tmp_path):
    """A chunk record replays row by row where no bucket kernel serves it: a
    kernel that cannot run here, or an engine serving eagerly. Either way each
    masked row is one update, in the record's order, as the kernel's scan."""
    from metrics_tpu_torch.engine import runtime as port_runtime

    rows = [(0, 0.9, 1), (1, 0.2, 1), (0, 0.7, 0), (1, 0.6, 1), (0, 0.1, 0)]
    _jax_journal(tmp_path, [_chunk_for({0: "a", 1: "b"}, rows)])
    make = (lambda: tcls.BinaryAccuracy(**CPU)) if route == "per_row_walk" else (
        lambda: tcls.BinaryAUROC(thresholds=None, **CPU))
    if route == "per_row_walk":
        class Refusing:
            def __call__(self, *args):
                raise port_runtime._FusedUnsupported("no kernel here")

        original = StreamingEngine._build_kernel
        StreamingEngine._build_kernel = lambda self: Refusing()
        try:
            engine = StreamingEngine(make(), buckets=(8,), checkpoint=_cfg(tmp_path))
        finally:
            StreamingEngine._build_kernel = original
        assert engine.fused
    else:
        engine = StreamingEngine(make(), buckets=(8,), checkpoint=_cfg(tmp_path))
        assert not engine.fused
    try:
        assert engine.telemetry_snapshot()["replayed"] == 1 and engine.telemetry_snapshot()["failed"] == 0
        metric = make()
        for key, slot in (("a", 0), ("b", 1)):
            mine = [(np.array([p], np.float32), np.array([t], np.int32)) for s, p, t in rows if s == slot]
            assert_trees_match(engine._keyed.state_of(key), fold_rows(metric, [(key, args) for args in mine])[key], key)
    finally:
        engine.close(checkpoint=False)
