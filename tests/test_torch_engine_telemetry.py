"""The port's engine telemetry and health (``metrics_tpu_torch/engine/telemetry.py``,
``StreamingEngine.health``) against the JAX package's, on the CPU: the snapshot's
keys and values for the same traffic, the health schema through its states, the
closed counter set, relabelling, retirement and the JSONL record."""

import json

import numpy as np
import pytest

import metrics_tpu.engine.telemetry as jtel
import metrics_tpu_torch.engine.telemetry as ttel
from metrics_tpu.engine import StreamingEngine as JaxEngine
from metrics_tpu_torch.engine import StreamingEngine
from metrics_tpu_torch.obs.registry import Registry
from tests.test_torch_engine import (  # noqa: F401  (_one_torch_thread: the autouse fixture)
    FAMILIES,
    WAIT_S,
    _one_torch_thread,
    _stream,
    run_stream,
    submit_in_one_drain,
)

# the health keys of an engine without planes (tests/engine/test_health_schema.py)
BASE_KEYS = {"state", "closed", "worker_alive", "worker_restarts", "zombie_workers", "queue_depth", "shedding",
             "wal_disabled", "breakers", "quarantined_tenants"}
# snapshot values that depend on time, not on the traffic
TIMED = ("latency_s", "resize_seconds")


def test_fresh_snapshot_equals_jax():
    port, ref = ttel.EngineTelemetry(), jtel.EngineTelemetry()
    assert port.snapshot() == ref.snapshot()
    assert list(port.snapshot()) == list(ref.snapshot())


def test_engine_snapshot_matches_jax_for_the_same_traffic():
    """Same keys in the same order; every count (submitted, processed, rows,
    padded rows, batches, compiles, the occupancy histogram) equal."""
    make_jax, make_port, gen = FAMILIES["accuracy"]
    stream = _stream(gen, seed=4, n=25, keys=3)
    ref, port = JaxEngine(make_jax(), buckets=(4, 16), capacity=4), StreamingEngine(make_port(), buckets=(4, 16),
                                                                                  capacity=4)
    try:
        for engine in (ref, port):
            # one drained batch, so both engines cut the same micro-batches
            futures = submit_in_one_drain(engine, stream)
            engine.flush(timeout=WAIT_S)
            assert all(f.result(timeout=WAIT_S) for f in futures)
        got, want = port.telemetry_snapshot(), ref.telemetry_snapshot()
        assert list(got) == list(want)
        for key in want:
            if key not in TIMED:
                assert got[key] == want[key], key
        assert got["latency_s"]["count"] == want["latency_s"]["count"] == len(stream)
        assert got["slab_bytes"] > 0 and got["batches"] >= 2
    finally:
        for engine in (ref, port):
            engine._worker_gate.set()
            engine.close()


def test_unknown_counter_raises_and_declared_one_counts():
    tel = ttel.EngineTelemetry(registry=Registry())
    with pytest.raises(KeyError, match="register_counter"):
        tel.count("typo_counter")
    tel.register_counter("custom")
    tel.count("custom", 3)
    assert tel.snapshot()["custom"] == 3


def test_latency_quantiles_are_nearest_rank_like_jax():
    port, ref = ttel.EngineTelemetry(latency_window=16), jtel.EngineTelemetry(latency_window=16)
    for v in np.random.default_rng(0).random(40):
        port.observe_latency(float(v))
        ref.observe_latency(float(v))
    assert port.snapshot()["latency_s"] == ref.snapshot()["latency_s"]


def test_relabel_carries_counters_and_retire_drops_the_series():
    reg = Registry()
    tel = ttel.EngineTelemetry(registry=reg)
    tel.count("processed", 5)
    tel.observe_batch(3, 8)
    tel.add_labels(partition="p1")
    assert tel.label("partition") == "p1"
    assert tel.snapshot()["processed"] == 5 and tel.snapshot()["rows"] == 3
    with pytest.raises(ValueError, match="one engine, one identity"):
        tel.add_labels(partition="p2")
    text = reg.render_prometheus()
    assert 'partition="p1"' in text and f'engine="{tel.engine_id}"' in text
    tel.retire()
    assert f'engine="{tel.engine_id}"' not in reg.render_prometheus()


def test_engine_series_reach_the_prometheus_text():
    from metrics_tpu_torch.obs.registry import REGISTRY

    engine = StreamingEngine(FAMILIES["accuracy"][1](), buckets=(8,), telemetry_labels={"shard": "3"})
    try:
        engine.submit("k", np.array([1], np.int32), np.array([1], np.int32)).result(timeout=WAIT_S)
        text = REGISTRY.render_prometheus()
        label = f'engine="{engine.telemetry.engine_id}"'
        assert f'metrics_tpu_torch_engine_events_total{{{label},event="processed",shard="3"}} 1' in text
        assert "metrics_tpu_torch_engine_batch_occupancy_bucket" in text
    finally:
        engine.close()
        engine.telemetry.retire()


def test_telemetry_emit_jsonl(tmp_path):
    path = str(tmp_path / "telemetry.jsonl")
    with StreamingEngine(FAMILIES["accuracy"][1](), buckets=(8,)) as engine:
        engine.submit("k", np.array([1], np.int32), np.array([1], np.int32))
        engine.flush(timeout=WAIT_S)
        record = engine.telemetry.emit(path, run="unit")
    lines = [json.loads(line) for line in open(path)]
    assert len(lines) == 1 and lines[0]["what"] == "engine_telemetry"
    assert lines[0]["processed"] == 1 and lines[0]["run"] == "unit" and "utc" in lines[0]
    assert record["latency_s"]["p99"] is not None


@pytest.fixture
def engines():
    port, ref = StreamingEngine(FAMILIES["mean"][1]()), JaxEngine(FAMILIES["mean"][0]())
    yield port, ref
    port.close()
    ref.close()


def test_health_schema_serving(engines):
    for engine in engines:
        engine.submit("k", np.array([1.0], np.float32))
        engine.flush(timeout=WAIT_S)
    got, want = (engine.health() for engine in engines)
    assert set(got) == set(want) == BASE_KEYS
    assert got == want
    assert got["state"] == "SERVING" and got["worker_alive"] is True and got["closed"] is False


def test_health_schema_is_stable_across_all_states(engines):
    """The key set does not morph with the state machine, and each state reads
    as the JAX engine's does."""
    for flag, state in (("_degraded", "DEGRADED"), ("_quarantined", "QUARANTINED")):
        for engine in engines:
            setattr(engine, flag, True)
        got, want = (engine.health() for engine in engines)
        assert got["state"] == want["state"] == state
        assert set(got) == set(want) == BASE_KEYS
        assert {k: got[k] for k in BASE_KEYS - {"worker_alive"}} == {k: want[k] for k in BASE_KEYS - {"worker_alive"}}
    for engine in engines:
        engine._degraded = engine._quarantined = False  # let the fixture close cleanly


def test_snapshot_of_an_eager_engine():
    import metrics_tpu_torch.classification as tcls

    engine = StreamingEngine(tcls.BinaryAUROC(thresholds=None, device="cpu"))
    try:
        run_stream(engine, [("x", (np.array([0.2, 0.9], np.float32), np.array([0, 1], np.int32)))])
        snap = engine.telemetry_snapshot()
        assert snap["fused"] is False and "slab_bytes" not in snap and snap["tenants"] == 1
    finally:
        engine.close()
