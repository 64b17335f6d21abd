"""The port's ``ShardedEngine`` (``metrics_tpu_torch/shard/engine.py``) against
the JAX package's and against one engine, on the CPU (twins of
``tests/shard/``).

Each shard is a port ``StreamingEngine`` (``device="cpu"``: the loop kernel).
Tenants are placed by the same ring in both packages, so the per-shard key
sets are compared exactly, and per-tenant values through ``compute_all`` are
compared exactly for the integer-state ``BinaryAccuracy`` (and within rtol
1e-6 across packages for ``MeanSquaredError``, whose float32 sums the two
frameworks may add in other orders; within the port, sharded against one
engine, they are bit-identical). The checkpoint cases cover the manifest and
its refusals (the JAX package's messages), ``resize`` with its crash windows,
tier migration, and a sharded checkpoint directory written by either package
and resumed by the other with every tenant on its ring shard.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import metrics_tpu.classification as jcls
import metrics_tpu.shard as jshard
import metrics_tpu_torch as tm
import metrics_tpu_torch.classification as tcls
from metrics_tpu.engine import CheckpointConfig as JaxCheckpointConfig
from metrics_tpu.regression import MeanSquaredError as JaxMSE
from metrics_tpu_torch import obs
from metrics_tpu_torch.engine import CheckpointConfig, GuardConfig, StreamingEngine, TierConfig
from metrics_tpu_torch.guard.errors import QuotaExceeded, TenantQuarantined
from metrics_tpu_torch.guard.faults import ManualClock, kill_dispatcher, poison_args
from metrics_tpu_torch.shard import ShardConfig, ShardedEngine
from metrics_tpu_torch.shard import engine as shard_engine
from metrics_tpu_torch.tier.residency import COLD, HOT
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from tests.test_torch_engine import _one_torch_thread  # noqa: F401  (the autouse fixture)

CPU = {"device": "cpu"}
WAIT_S = 60


def _acc():
    return tcls.BinaryAccuracy(**CPU)


def _cfg(shards, **kw):
    return ShardConfig(shards=shards, place_on_mesh=False, **kw)


def _traffic(rng, n_keys=16, n_requests=60, rows=8):
    keys = [f"tenant-{i}" for i in range(n_keys)]
    out = []
    for _ in range(n_requests):
        k = keys[int(rng.integers(n_keys))]
        out.append((k, rng.integers(0, 2, size=rows).astype(np.float32), rng.integers(0, 2, size=rows).astype(np.int32)))
    return out


def _drive(engine, traffic):
    futures = [engine.submit(k, p, t) for k, p, t in traffic]
    engine.flush(timeout=WAIT_S)
    for fut in futures:
        assert fut.exception(timeout=WAIT_S) is None
    return futures


def _values(engine, window=False):
    return {k: float(v) for k, v in engine.compute_all(window=window).items()}


def _shard_keys(engine):
    return [set(e._keyed.keys) | set(e._tier.keys() if e._tier is not None else ()) for e in engine.engines]


# ------------------------------------------------------------------------ parity


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_bit_identical_to_one_engine_and_to_jax(shards):
    """Per-tenant values equal one port engine's and the JAX sharded engine's,
    with every tenant on the same shard in both packages."""
    traffic = _traffic(np.random.default_rng(shards))
    sharded = ShardedEngine(_acc(), config=_cfg(shards))
    oracle = StreamingEngine(_acc())
    ref = jshard.ShardedEngine(jcls.BinaryAccuracy(), config=jshard.ShardConfig(shards=shards, place_on_mesh=False))
    try:
        _drive(sharded, traffic)
        _drive(oracle, traffic)
        _drive(ref, traffic)
        got, want = _values(sharded), _values(oracle)
        assert got == want == _values(ref)
        assert _shard_keys(sharded) == [set(e._keyed.keys) for e in ref.engines]
        assert sharded.keys == ref.keys
    finally:
        sharded.close()
        oracle.close()
        ref.close()


def test_float_metric_bit_identical_to_one_engine():
    rng = np.random.default_rng(7)
    keys = [f"t{i}" for i in range(10)]
    sharded = ShardedEngine(tm.MeanSquaredError(**CPU), config=_cfg(4))
    oracle = StreamingEngine(tm.MeanSquaredError(**CPU))
    ref = jshard.ShardedEngine(JaxMSE(), config=jshard.ShardConfig(shards=4, place_on_mesh=False))
    try:
        for _ in range(40):
            k = keys[int(rng.integers(len(keys)))]
            p, t = rng.normal(size=8).astype(np.float32), rng.normal(size=8).astype(np.float32)
            for e in (sharded, oracle, ref):
                e.submit(k, p, t)
        got, want, jax_vals = sharded.compute_all(), oracle.compute_all(), ref.compute_all()
        for key in want:
            assert got[key].dtype == torch.float32 and torch.equal(got[key], want[key]), key
            np.testing.assert_allclose(got[key].numpy(), np.asarray(jax_vals[key]), rtol=1e-6)
    finally:
        sharded.close()
        oracle.close()
        ref.close()


def test_windowed_parity_through_rotations():
    sharded = ShardedEngine(_acc(), config=_cfg(4), window=3)
    oracle = StreamingEngine(_acc(), window=3)
    try:
        for engine in (sharded, oracle):
            rng = np.random.default_rng(3)
            for _ in range(5):  # > window: oldest segments must expire identically
                _drive(engine, _traffic(rng, n_requests=20))
                engine.rotate_window()
        assert _values(sharded, window=True) == _values(oracle, window=True)
    finally:
        sharded.close()
        oracle.close()


def test_one_shard_dispatcher_death_is_contained_and_replayed():
    traffic = _traffic(np.random.default_rng(11), n_requests=80)
    sharded = ShardedEngine(_acc(), config=_cfg(4))
    oracle = StreamingEngine(_acc())
    try:
        half = len(traffic) // 2
        _drive(sharded, traffic[:half])
        kill_dispatcher(sharded.engines[1])
        for k, p, t in traffic[half:]:
            sharded.submit(k, p, t)
        sharded.flush(timeout=WAIT_S)
        assert sharded.engines[1].degraded and not sharded.engines[0].degraded
        assert sharded.health()["state"] == "DEGRADED"
        _drive(oracle, traffic)
        assert _values(sharded) == _values(oracle)
    finally:
        sharded.close()
        oracle.close()


def test_eager_metric_shards_too():
    sharded = ShardedEngine(tcls.BinaryAUROC(thresholds=None, **CPU), config=_cfg(3))
    oracle = StreamingEngine(tcls.BinaryAUROC(thresholds=None, **CPU))
    try:
        assert not sharded.engines[0].fused
        rng = np.random.default_rng(5)
        for _ in range(30):
            k = f"t{int(rng.integers(8))}"
            p, t = rng.random(5, dtype=np.float32), rng.integers(0, 2, 5).astype(np.int32)
            sharded.submit(k, p, t)
            oracle.submit(k, p, t)
        assert _values(sharded) == _values(oracle)
    finally:
        sharded.close()
        oracle.close()


def test_routing_is_ring_stable_and_tenants_are_disjoint():
    sharded = ShardedEngine(_acc(), config=_cfg(4))
    try:
        _drive(sharded, _traffic(np.random.default_rng(2)))
        seen = {}
        for index, engine in enumerate(sharded.engines):
            for key in engine._keyed.keys:
                assert key not in seen
                seen[key] = index
                assert sharded.shard_of(key) == index == jshard.HashRing(4).shard_for(key)
    finally:
        sharded.close()


def test_validation_and_close_match_jax():
    for make, cfg, metric in ((ShardedEngine, ShardConfig, _acc), (jshard.ShardedEngine, jshard.ShardConfig,
                                                                     jcls.BinaryAccuracy)):
        with pytest.raises(Exception, match="needs >= 1 shard, got 0") as err:
            make(metric(), config=cfg(shards=0))
        assert type(err.value).__name__ == "MetricsTPUUserError"
        engine = make(metric(), config=cfg(shards=2, place_on_mesh=False))
        engine.close()
        engine.close()  # second close is a no-op
        with pytest.raises(Exception, match="resize\\(\\) on a closed ShardedEngine"):
            engine.resize(4)


def test_telemetry_snapshot_aggregates_and_labels():
    engine = ShardedEngine(_acc(), config=_cfg(2))
    try:
        _drive(engine, _traffic(np.random.default_rng(9), n_requests=20))
        snap = engine.telemetry_snapshot()
        assert snap["processed"] == 20 and set(snap["shards"]) == {"0", "1"}
        assert sum(s["processed"] for s in snap["shards"].values()) == 20
        assert engine.engines[0].telemetry.label("shard") == "0"
        assert engine.engines[1].telemetry.label("shard") == "1"
    finally:
        engine.close()


def test_shard_series_are_published_under_the_port_names():
    obs.reset()
    obs.enable()
    try:
        engine = ShardedEngine(_acc(), config=_cfg(2))
        try:
            _drive(engine, _traffic(np.random.default_rng(4), n_requests=20))
            engine.publish_tenant_gauges()
            engine.resize(3)
            text = obs.REGISTRY.render_prometheus()
        finally:
            engine.close()
    finally:
        obs.disable()
        obs.reset()
    assert f'metrics_tpu_torch_shard_rebalances_total{{engine="{engine.engine_id}"}} 1' in text
    for shard in range(3):
        assert f'metrics_tpu_torch_shard_tenants{{engine="{engine.engine_id}",shard="{shard}"}}' in text


def test_placement_deals_shards_over_the_visible_cards(monkeypatch):
    """With more than one card visible, shard i serves on cuda:{i % n}; with one
    card or none (or placement off), every shard gets the default device."""
    built = []

    class _Recorder:
        def __init__(self, metric, *, start=True, **kwargs):
            built.append(kwargs.get("device"))
            self._keyed = type("K", (), {"keys": ()})()
            self._tier = None
            self.device = kwargs.get("device")

        def close(self, **kw):
            pass

    monkeypatch.setattr(shard_engine, "StreamingEngine", _Recorder)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    engine = ShardedEngine(_acc(), config=ShardConfig(shards=5))
    assert built == [torch.device(f"cuda:{i % 3}") for i in range(5)]
    assert engine.mesh == tuple(torch.device(f"cuda:{j}") for j in range(3))
    assert engine.sharding == tuple(built)
    built.clear()
    engine = ShardedEngine(_acc(), config=ShardConfig(shards=2, place_on_mesh=False), device="cpu")
    assert built == ["cpu", "cpu"] and engine.mesh is None and engine.sharding is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    built.clear()
    engine = ShardedEngine(_acc(), config=ShardConfig(shards=2))
    assert built == [None, None] and engine.mesh is None


# -------------------------------------------------------------------- rebalance


def _drive_pair(sharded, oracle, rng, n=40, n_keys=12):
    traffic = _traffic(rng, n_keys=n_keys, n_requests=n)
    _drive(sharded, traffic)
    _drive(oracle, traffic)


def test_resize_moves_only_ring_moved_tenants_to_new_shards():
    sharded = ShardedEngine(_acc(), config=_cfg(2))
    oracle = StreamingEngine(_acc())
    try:
        _drive_pair(sharded, oracle, np.random.default_rng(0))
        before = {k: sharded.shard_of(k) for k in sharded.keys}
        moved = sharded.resize(4)
        assert moved == {k: (before[k], jshard.HashRing(4).shard_for(k)) for k in before
                         if jshard.HashRing(4).shard_for(k) != before[k]}
        for key, (src, dst) in moved.items():
            assert dst >= 2 and sharded.shard_of(key) == dst and key in sharded.engines[dst]._keyed.keys
            assert key not in sharded.engines[src]._keyed.keys
        assert _values(sharded) == _values(oracle)
    finally:
        sharded.close()
        oracle.close()


def test_resize_preserves_window_ring_bit_identically():
    sharded = ShardedEngine(_acc(), config=_cfg(2), window=3)
    oracle = StreamingEngine(_acc(), window=3)
    try:
        rng = np.random.default_rng(4)
        for _ in range(2):
            _drive_pair(sharded, oracle, rng, n=25)
            sharded.rotate_window()
            oracle.rotate_window()
        _drive_pair(sharded, oracle, rng, n=25)
        sharded.resize(6)
        assert _values(sharded, window=True) == _values(oracle, window=True)
        _drive_pair(sharded, oracle, rng, n=25)
        sharded.rotate_window()
        oracle.rotate_window()
        assert _values(sharded, window=True) == _values(oracle, window=True)
    finally:
        sharded.close()
        oracle.close()


def test_resize_float_states_bit_identical():
    sharded = ShardedEngine(tm.MeanSquaredError(**CPU), config=_cfg(2))
    oracle = StreamingEngine(tm.MeanSquaredError(**CPU))
    try:
        rng = np.random.default_rng(9)
        for _ in range(50):
            k = f"t{int(rng.integers(10))}"
            p, t = rng.normal(size=8).astype(np.float32), rng.normal(size=8).astype(np.float32)
            sharded.submit(k, p, t)
            oracle.submit(k, p, t)
        sharded.flush()
        sharded.resize(8)
        got, want = sharded.compute_all(), oracle.compute_all()
        assert all(torch.equal(got[k], want[k]) for k in want)
    finally:
        sharded.close()
        oracle.close()


def test_resize_under_concurrent_submitters():
    sharded = ShardedEngine(_acc(), config=_cfg(2))
    oracle = StreamingEngine(_acc())
    errors = []
    try:
        plan = _traffic(np.random.default_rng(1), n_keys=10, n_requests=120, rows=4)

        def submitter(part):
            try:
                for k, p, t in part:
                    sharded.submit(k, p, t)
            except Exception as exc:  # pragma: no cover - surfaced below
                errors.append(exc)

        threads = [threading.Thread(target=submitter, args=(plan[i::3],)) for i in range(3)]
        for th in threads:
            th.start()
        sharded.resize(4)
        for th in threads:
            th.join(timeout=WAIT_S)
        assert not errors
        sharded.flush(timeout=WAIT_S)
        _drive(oracle, plan)
        assert _values(sharded) == _values(oracle)
    finally:
        sharded.close()
        oracle.close()


def test_resize_validations_and_double_resize():
    sharded = ShardedEngine(_acc(), config=_cfg(1))
    oracle = StreamingEngine(_acc())
    try:
        for n in (1, 0):
            with pytest.raises(MetricsTPUUserError, match="only grows"):
                sharded.resize(n)
        rng = np.random.default_rng(6)
        _drive_pair(sharded, oracle, rng)
        sharded.resize(2)
        _drive_pair(sharded, oracle, rng)
        sharded.resize(4)
        _drive_pair(sharded, oracle, rng)
        assert sharded.shards == 4 and _values(sharded) == _values(oracle)
    finally:
        sharded.close()
        oracle.close()


# ------------------------------------------------------------------- checkpoints


def _ck(tmp_path, cls=CheckpointConfig, **kw):
    return cls(directory=str(tmp_path / "ckpt"), interval_s=3600.0, **kw)


def test_crash_recovery_from_wal_and_from_the_final_snapshot(tmp_path):
    for shards, crash in ((2, True), (4, False)):
        ck = _ck(tmp_path / str(shards))
        first = ShardedEngine(_acc(), config=_cfg(shards), checkpoint=ck)
        _drive(first, _traffic(np.random.default_rng(shards), n_keys=10, n_requests=30, rows=4))
        want = _values(first)
        first.close(checkpoint=not crash)
        second = ShardedEngine(_acc(), config=_cfg(shards), checkpoint=ck)
        try:
            assert _values(second) == want
            snaps = [e.telemetry.snapshot() for e in second.engines]
            if crash:
                assert sum(s["replayed"] for s in snaps) > 0
            else:
                assert sum(s["recoveries"] for s in snaps) == shards
        finally:
            second.close()


def test_per_shard_directories_and_manifest(tmp_path):
    ck = _ck(tmp_path)
    engine = ShardedEngine(_acc(), config=_cfg(3), checkpoint=ck)
    try:
        _drive(engine, _traffic(np.random.default_rng(1), n_requests=10))
        engine.checkpoint_now()
        for i in range(3):
            assert os.path.isdir(os.path.join(ck.directory, f"shard-{i:03d}"))
        with open(os.path.join(ck.directory, "shard_manifest.json")) as fh:
            assert json.load(fh) == {"shards": 3, "vnodes": 256, "seed": 0}
    finally:
        engine.close()


def test_manifest_refusals_carry_the_jax_messages(tmp_path):
    ck, jck = _ck(tmp_path / "port"), _ck(tmp_path / "jax", JaxCheckpointConfig)
    ShardedEngine(_acc(), config=_cfg(2), checkpoint=ck).close()
    jshard.ShardedEngine(jcls.BinaryAccuracy(), config=jshard.ShardConfig(shards=2, place_on_mesh=False),
                         checkpoint=jck).close()
    for kw in ({"shards": 2, "seed": 7}, {"shards": 4}):
        with pytest.raises(MetricsTPUUserError) as got:
            ShardedEngine(_acc(), config=_cfg(**kw), checkpoint=ck)
        with pytest.raises(Exception) as want:
            jshard.ShardedEngine(jcls.BinaryAccuracy(), config=jshard.ShardConfig(place_on_mesh=False, **kw),
                                 checkpoint=jck)
        assert str(got.value).replace(ck.directory, "D") == str(want.value).replace(jck.directory, "D")


def test_resize_rewrites_manifest_and_resumes(tmp_path):
    ck = _ck(tmp_path)
    first = ShardedEngine(_acc(), config=_cfg(2), checkpoint=ck)
    _drive(first, _traffic(np.random.default_rng(5), n_keys=10, n_requests=30, rows=4))
    first.resize(4)
    want = _values(first)
    first.close(checkpoint=False)
    with open(os.path.join(ck.directory, "shard_manifest.json")) as fh:
        assert json.load(fh)["shards"] == 4
    second = ShardedEngine(_acc(), config=_cfg(4), checkpoint=ck)
    try:
        assert _values(second) == want
    finally:
        second.close()


def test_crash_mid_rebalance_double_copy_is_swept(tmp_path):
    ck = _ck(tmp_path)
    first = ShardedEngine(_acc(), config=_cfg(4), checkpoint=ck)
    _drive(first, _traffic(np.random.default_rng(8), n_keys=10, n_requests=30, rows=4))
    want = _values(first)
    victim = first.keys[0]
    owner = first.shard_of(victim)
    wrong = (owner + 1) % 4
    src, dst = first.engines[owner], first.engines[wrong]
    with src._dispatch_lock:
        tree = ShardedEngine._export_tenant(src._keyed, victim)
    with dst._dispatch_lock:
        ShardedEngine._install_tenant(dst._keyed, victim, tree)
    first.checkpoint_now()
    first.close(checkpoint=False)
    second = ShardedEngine(_acc(), config=_cfg(4), checkpoint=ck)
    try:
        assert _values(second) == want
        assert victim not in second.engines[wrong]._keyed.keys and victim in second.engines[owner]._keyed.keys
    finally:
        second.close()


def test_crash_before_manifest_commit_loses_nothing(tmp_path, monkeypatch):
    ck = _ck(tmp_path)
    first = ShardedEngine(_acc(), config=_cfg(2), checkpoint=ck)
    _drive(first, _traffic(np.random.default_rng(11), n_keys=10, n_requests=30, rows=4))
    want = _values(first)

    def torn(directory, manifest):
        raise RuntimeError("simulated crash before manifest commit")

    monkeypatch.setattr(ShardedEngine, "_write_manifest", staticmethod(torn))
    with pytest.raises(RuntimeError):
        first.resize(4)
    first.close(checkpoint=False)
    monkeypatch.undo()
    with open(os.path.join(ck.directory, "shard_manifest.json")) as fh:
        assert json.load(fh)["shards"] == 2
    second = ShardedEngine(_acc(), config=_cfg(2), checkpoint=ck)
    try:
        assert _values(second) == want
        second.resize(4)
        assert _values(second) == want
        all_keys = [k for e in second.engines for k in e._keyed.keys]
        assert len(all_keys) == len(set(all_keys))
    finally:
        second.close()


def test_born_shard_drops_stale_recovered_state(tmp_path):
    ck = _ck(tmp_path)
    engine = ShardedEngine(_acc(), config=_cfg(2), checkpoint=ck)
    _drive(engine, _traffic(np.random.default_rng(13), n_keys=10, n_requests=30, rows=4))
    want = _values(engine)
    stale = StreamingEngine(_acc(), checkpoint=dataclasses.replace(ck, directory=os.path.join(ck.directory, "shard-002")))
    stale.submit("ghost", np.ones(4, np.float32), np.ones(4, np.int32))
    stale.close()
    engine.resize(4)
    try:
        assert "ghost" not in engine.keys and _values(engine) == want
    finally:
        engine.close()
    second = ShardedEngine(_acc(), config=_cfg(4), checkpoint=ck)
    try:
        assert "ghost" not in second.keys and _values(second) == want
    finally:
        second.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_sharded_directory_of_either_package_resumes_in_the_other(writer, tmp_path):
    """The writer serves on 2 shards, resizes to 4, serves more and crashes (WAL
    only past the resize's snapshots); the reader resumes the directory on 4
    shards with every tenant on its ring shard and the same values."""
    rng = np.random.default_rng(21)
    first, second = _traffic(rng, n_keys=12, n_requests=30, rows=4), _traffic(rng, n_keys=12, n_requests=30, rows=4)
    if writer == "jax":
        w = jshard.ShardedEngine(jcls.BinaryAccuracy(), config=jshard.ShardConfig(shards=2, place_on_mesh=False),
                                 checkpoint=_ck(tmp_path, JaxCheckpointConfig))
    else:
        w = ShardedEngine(_acc(), config=_cfg(2), checkpoint=_ck(tmp_path))
    try:
        _drive(w, first)
        w.resize(4)
        _drive(w, second)
        want = _values(w)
    finally:
        w.close(checkpoint=False)
    if writer == "jax":
        r = ShardedEngine(_acc(), config=_cfg(4), checkpoint=_ck(tmp_path))
    else:
        r = jshard.ShardedEngine(jcls.BinaryAccuracy(), config=jshard.ShardConfig(shards=4, place_on_mesh=False),
                                 checkpoint=_ck(tmp_path, JaxCheckpointConfig))
    try:
        assert _values(r) == want
        ring = jshard.HashRing(4)
        for index, engine in enumerate(r.engines):
            assert all(ring.shard_for(k) == index for k in engine._keyed.keys)
        assert sorted(r.keys) == sorted(want)
    finally:
        r.close(checkpoint=False)


# ------------------------------------------------------------------ tier plane


def _tier_cfg(tmp_path, **kw):
    kw.setdefault("hot_capacity", 3)
    kw.setdefault("warm_capacity", 2)
    kw.setdefault("spill_directory", str(tmp_path / "spill"))
    kw.setdefault("idle_demote_s", 0.01)
    kw.setdefault("check_interval_s", 0.0)
    return TierConfig(**kw)


def _tiered(tmp_path, shards=2, **kw):
    return ShardedEngine(_acc(), config=_cfg(shards), buckets=(8,), tier=_tier_cfg(tmp_path), **kw)


def _spread(engine, n=12):
    rng = np.random.default_rng(0)
    expect = {}
    for i in range(n):
        preds, target = rng.integers(0, 2, 5), rng.integers(0, 2, 5)
        engine.submit(f"k{i}", preds, target)
        expect[f"k{i}"] = float(np.float32((preds == target).mean()))
    engine.flush()
    for _ in range(3):
        threading.Event().wait(0.03)
        engine.submit("k0", np.empty(0, np.int32), np.empty(0, np.int32))
        engine.flush()
    return expect


def test_resize_migrates_every_tier(tmp_path):
    engine = _tiered(tmp_path)
    try:
        expect = _spread(engine)
        engine.register_tenants([f"silent{i}" for i in range(50)])
        assert {engine.tenant_tier(k) for k in expect} > {HOT}
        assert engine.resize(4)
        for key, want in expect.items():
            assert float(engine.compute(key)) == pytest.approx(want), key
        assert engine.tier_stats()["cold"] >= 50
        assert all(engine.tenant_tier(f"silent{i}") == COLD for i in range(50))
        assert len(engine.keys) == len(expect) + 50
    finally:
        engine.close()


def test_resize_preserves_window_history_across_tiers(tmp_path):
    engine = ShardedEngine(_acc(), config=_cfg(2), buckets=(8,), window=3, tier=_tier_cfg(tmp_path))
    try:
        rng = np.random.default_rng(1)
        totals = {f"k{i}": [0, 0] for i in range(8)}
        for _ in range(2):
            for key in totals:
                preds, target = rng.integers(0, 2, 4), rng.integers(0, 2, 4)
                engine.submit(key, preds, target)
                totals[key][0] += int((preds == target).sum())
                totals[key][1] += 4
            engine.flush()
            engine.rotate_window()
        for _ in range(3):
            threading.Event().wait(0.03)
            engine.submit("k0", np.empty(0, np.int32), np.empty(0, np.int32))
            engine.flush()
        engine.resize(4)
        for key, (hit, n) in totals.items():
            assert float(engine.compute(key, window=True)) == pytest.approx(hit / n), key
    finally:
        engine.close()


def test_per_shard_spill_directories_and_tier_stats(tmp_path):
    engine = _tiered(tmp_path)
    try:
        expect = _spread(engine)
        spill_root = str(tmp_path / "spill")
        subdirs = sorted(d for d in os.listdir(spill_root) if d.startswith("shard-"))
        assert subdirs == ["shard-000", "shard-001"]
        files = [name for sub in subdirs for name in os.listdir(os.path.join(spill_root, sub))]
        assert any(name.endswith(".mtckpt") for name in files)
        engine.register_tenants(["s1", "s2"])
        stats = engine.tier_stats()
        assert len(stats["shards"]) == 2 and stats["slab_bytes"] > 0
        assert stats["hot"] + stats["warm"] + stats["cold"] == len(expect) + 2
    finally:
        engine.close()


def test_recovery_sweep_evicts_stale_tiered_copies(tmp_path):
    ckpt = CheckpointConfig(directory=str(tmp_path / "ckpt"), interval_s=3600.0)
    engine = _tiered(tmp_path, checkpoint=ckpt)
    expect = _spread(engine)
    engine.checkpoint_now()
    engine.resize(4)
    engine.checkpoint_now()
    engine.close(checkpoint=True)
    recovered = _tiered(tmp_path, shards=4, checkpoint=ckpt)
    try:
        seen = list(recovered.keys)
        assert len(seen) == len(set(seen))
        for key, want in expect.items():
            assert float(recovered.compute(key)) == pytest.approx(want), key
    finally:
        recovered.close()


# ------------------------------------------------------------------ guard plane


def _keys_on_distinct_shards(engine, n=2):
    picked, shards, i = [], set(), 0
    while len(picked) < n:
        key = f"tenant-{i}"
        if engine.shard_of(key) not in shards:
            shards.add(engine.shard_of(key))
            picked.append(key)
        i += 1
    return picked


def _good(rows=4):
    return np.ones(rows, np.float32), np.ones(rows, np.int32)


def test_quarantine_is_shard_local():
    engine = ShardedEngine(_acc(), config=_cfg(4), guard=GuardConfig(quarantine_threshold=2, clock=ManualClock()))
    try:
        victim, bystander = _keys_on_distinct_shards(engine, 2)
        p, t = poison_args()
        for _ in range(2):
            assert engine.submit(victim, p, t).exception(timeout=WAIT_S) is not None
            engine.flush()
        with pytest.raises(TenantQuarantined):
            engine.submit(victim, *_good())
        for index, shard in enumerate(engine.engines):
            quarantined = shard.health()["quarantined_tenants"]
            assert (victim in quarantined) if index == engine.shard_of(victim) else not quarantined
        assert engine.submit(bystander, *_good()).exception(timeout=WAIT_S) is None
        assert float(engine.compute(bystander)) == 1.0
        assert engine.engines[engine.shard_of(bystander)].health()["state"] == "SERVING"
    finally:
        engine.close()


def test_quota_buckets_are_per_tenant_per_shard():
    guard = GuardConfig(clock=ManualClock(), quota_rows_per_s=2.0, quota_burst_rows=4.0)
    engine = ShardedEngine(_acc(), config=_cfg(4), guard=guard)
    try:
        greedy, modest = _keys_on_distinct_shards(engine, 2)
        assert engine.submit(greedy, *_good(4)).exception(timeout=WAIT_S) is None
        with pytest.raises(QuotaExceeded):
            engine.submit(greedy, *_good(4))
        assert engine.submit(modest, *_good(4)).exception(timeout=WAIT_S) is None
        engine.flush()
    finally:
        engine.close()


def test_launch_tallies_are_per_thread():
    """A capture counts its own thread's launches only: shards capture at once on
    one card, and the wrappers' counters are process-wide."""
    from metrics_tpu_torch.kernels import _tally

    seen = {}
    go = threading.Barrier(2)

    def capture_like(name, n):
        with _tally.counting() as tally:
            go.wait(timeout=WAIT_S)
            for _ in range(n):
                _tally.record(name)
            go.wait(timeout=WAIT_S)
        seen[name] = dict(tally)

    threads = [threading.Thread(target=capture_like, args=(name, n)) for name, n in (("pair_count", 3), ("hist_add", 5))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=WAIT_S)
    assert seen == {"pair_count": {"pair_count": 3}, "hist_add": {"hist_add": 5}}
    _tally.record("pair_count")  # no tally open on this thread: nothing to count into
    with _tally.counting() as outer:
        _tally.record("stat_scores", 2)
        with _tally.counting() as inner:
            _tally.record("stat_scores")
    assert inner == {"stat_scores": 1} and outer == {"stat_scores": 3}


class _SlowCapture:
    """A graph kernel whose first call (warm-up and capture) takes ``seconds``,
    past the watchdog timeout, after meeting ``barrier``; its "graph" replays
    the CPU loop kernel on the static inputs."""

    def __init__(self, engine, seconds, barrier=None):
        from metrics_tpu_torch.engine.runtime import _GraphKernel, _LoopKernel

        class Kernel(_GraphKernel):
            def _build(self, keyed, key_ids, mask, columns):
                if barrier is not None:
                    barrier.wait(timeout=WAIT_S)
                time.sleep(seconds)
                self._static = [t.clone() for t in (key_ids, mask, *columns)]
                self.graph = self

            def replay(self):
                kids, msk, *cols = self._static
                loop(self._keyed, kids, msk, cols)

            def __call__(self, keyed, key_ids, mask, columns):
                self._keyed = keyed
                super().__call__(keyed, key_ids, mask, columns)

        loop = _LoopKernel(engine._metric.update_state)
        self.kernel = Kernel(engine._metric.update_state, None, None, engine._hang_detector)


@pytest.mark.parametrize("crowd, hung", [(1, True), (4, False)])
def test_a_stretched_deadline_counts_from_the_batch_and_restarts_after(crowd, hung):
    from metrics_tpu_torch.guard import HangDetector

    clock = ManualClock()
    detector = HangDetector(0.5, clock=clock)
    detector.mark_busy()
    with detector.stretched(lambda: crowd):
        clock.advance(1.0)  # the batch's clock runs through the block: 1.0 s against 0.5 x crowd
        assert detector.hung() is hung
    assert not detector.hung()  # a fresh clock for the work after the block
    clock.advance(0.6)
    assert detector.hung()
    detector.mark_idle()
    with detector.stretched(lambda: crowd):
        clock.advance(9.0)
    assert not detector.hung()  # an idle detector stays idle


def test_a_capture_past_the_watchdog_timeout_is_no_hang():
    """Four shards' first calls at once, each past the timeout (as eight shards
    capturing at once on one card took): each counts against the timeout times
    the first calls in flight beside it, so no takeover, no quarantine, and the
    rows land."""
    guard = GuardConfig(watchdog_timeout_s=0.3, watchdog_poll_s=0.02)
    sharded = ShardedEngine(_acc(), config=_cfg(4), buckets=(8,), guard=guard)
    oracle = StreamingEngine(_acc(), buckets=(8,))
    together = threading.Barrier(4)
    for engine in sharded.engines:
        engine._build_kernel = lambda engine=engine: _SlowCapture(engine, 0.6, together).kernel
    try:
        firsts = [(key, *_good(2)) for key in _keys_on_distinct_shards(sharded, 4)]
        _drive(sharded, firsts)
        _drive(oracle, firsts)
        traffic = _traffic(np.random.default_rng(12), n_keys=4, n_requests=6, rows=2)
        _drive(sharded, traffic)
        _drive(oracle, traffic)
        snap = sharded.telemetry_snapshot()
        assert snap["worker_hangs"] == snap["watchdog_restarts"] == 0
        assert not any(e.quarantined or e.degraded for e in sharded.engines)
        assert sharded.health()["state"] == "SERVING" and _values(sharded) == _values(oracle)
    finally:
        sharded.close()
        oracle.close()


def test_a_lone_capture_past_the_watchdog_timeout_is_a_hang():
    """With no other first call in flight the deadline is the plain timeout, as
    the JAX package's watchdog counts a compile: a warm-up or capture that
    wedges past it is caught."""
    engine = StreamingEngine(_acc(), buckets=(8,), guard=GuardConfig(watchdog_timeout_s=0.2, watchdog_poll_s=0.02))
    engine._build_kernel = lambda: _SlowCapture(engine, 1.5).kernel
    try:
        engine.submit("t0", *_good(2))
        deadline = time.monotonic() + WAIT_S
        while engine.telemetry_snapshot()["worker_hangs"] == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert engine.telemetry_snapshot()["worker_hangs"] == 1
    finally:
        engine.close()
