"""The port's background checkpointer (``metrics_tpu_torch/ckpt/writer.py``) and
the durable state plane's obs series (``metrics_tpu_torch/obs/instrument.py``).

One counterpart for each test of ``tests/ckpt/test_writer.py`` and
``tests/obs/test_ckpt_obs.py``, run on the port: its series are the JAX
package's under the port's family names (``metrics_tpu_torch_ckpt_*``), they
render through the registry's Prometheus text and JSONL emitter, and they stay
silent while ``obs`` is disabled. A snapshot the port's writer commits is read
by the JAX package's store.
"""

import json

import numpy as np
import pytest
import torch

from metrics_tpu.ckpt import SnapshotStore as JaxStore
from metrics_tpu_torch import obs
from metrics_tpu_torch.ckpt import AsyncCheckpointer, SnapshotStore
from metrics_tpu_torch.ckpt.faults import DiskFull
from metrics_tpu_torch.classification import BinaryAccuracy
from metrics_tpu_torch.obs import instrument
from tests.obs.prom_grammar import parse as parse_prometheus


def _view(val=1.0):
    return lambda: ({"x": np.full(8, val, np.float32)}, {"val": val})


@pytest.fixture
def store(tmp_path):
    return SnapshotStore(str(tmp_path), retain=4, durable=False)


# --------------------------------------------------------------------------- tests/ckpt/test_writer.py


class TestAsyncWrites:
    def test_background_commit_lands(self, store):
        w = AsyncCheckpointer(store, interval_s=0.0)
        assert w.maybe_checkpoint(_view(3.0))
        assert w.quiesce(timeout=10.0)
        w.close()
        assert w.writes == 1 and w.last_generation == 0
        gen, snap = store.latest_valid()
        assert float(snap.tree["x"][0]) == 3.0 and snap.meta["val"] == 3.0

    def test_interval_gates_submissions(self, store):
        w = AsyncCheckpointer(store, interval_s=3600.0)
        assert w.maybe_checkpoint(_view()) is False  # not due yet (fresh timer)
        assert w.maybe_checkpoint(_view(), force=True)
        assert w.quiesce(timeout=10.0)
        w.close()
        assert w.writes == 1

    def test_busy_writer_skips_not_queues(self, store):
        w = AsyncCheckpointer(store, interval_s=0.0)
        calls = []
        w._idle.clear()  # an in-flight write holds the writer
        assert w.maybe_checkpoint(lambda: calls.append(1) or ({"x": np.ones(1)}, None)) is False
        assert w.skipped == 1 and calls == []
        w._idle.set()
        w.close()

    def test_checkpoint_sync_returns_generation(self, store):
        w = AsyncCheckpointer(store, interval_s=3600.0)
        assert w.checkpoint_sync(_view(7.0)) == 0
        assert w.checkpoint_sync(_view(8.0)) == 1
        w.close()
        gen, snap = store.latest_valid()
        assert gen == 1 and float(snap.tree["x"][0]) == 8.0

    def test_on_commit_hook_sees_generation_and_tree(self, store):
        seen = []
        w = AsyncCheckpointer(store, interval_s=0.0, on_commit=lambda g, t, m: seen.append((g, m)))
        w.checkpoint_sync(_view(5.0))
        w.close()
        assert seen == [(0, {"val": 5.0})]


class TestFailureAbsorption:
    def test_failed_write_counted_not_raised(self, store):
        errors = []
        w = AsyncCheckpointer(store, interval_s=0.0, on_error=errors.append)
        with DiskFull():
            assert w.checkpoint_sync(_view()) is None
        assert w.failures == 1 and w.consecutive_failures == 1
        assert isinstance(w.last_error, OSError)
        assert len(errors) == 1
        assert w.checkpoint_sync(_view(2.0)) == 0  # the writer recovers on the next attempt
        assert w.consecutive_failures == 0
        w.close()

    def test_unserializable_tree_absorbed(self, store):
        w = AsyncCheckpointer(store, interval_s=0.0)

        class Evil:
            def __reduce__(self):
                raise RuntimeError("nope")

        assert w.checkpoint_sync(lambda: ({"bad": Evil()}, None)) is None
        assert w.failures == 1
        w.close()

    def test_a_tensor_on_a_device_in_the_view_is_a_failed_write(self, store):
        """The view must hold numpy leaves: a tensor the format cannot turn into
        numpy (a meta tensor here, as a CUDA one on the card) fails the write,
        absorbed and counted, and commits nothing."""
        w = AsyncCheckpointer(store, interval_s=0.0)
        assert w.checkpoint_sync(lambda: ({"x": torch.empty(3, device="meta")}, None)) is None
        assert w.failures == 1 and store.generations() == []
        w.close()


def test_a_port_commit_is_read_by_the_jax_store(tmp_path):
    w = AsyncCheckpointer(SnapshotStore(str(tmp_path), durable=False), interval_s=0.0, site="engine")
    w.checkpoint_sync(lambda: ({"counts": np.arange(4, dtype=np.int32)}, {"seq": 9}))
    w.close()
    gen, snap = JaxStore(str(tmp_path), durable=False).latest_valid()
    assert gen == 0 and snap.meta == {"seq": 9}
    assert snap.tree["counts"].dtype == np.int32 and snap.tree["counts"].tolist() == [0, 1, 2, 3]


# --------------------------------------------------------------------------- tests/obs/test_ckpt_obs.py

_FAMILIES = (
    "metrics_tpu_torch_ckpt_bytes_total",
    "metrics_tpu_torch_ckpt_seconds",
    "metrics_tpu_torch_ckpt_failures_total",
    "metrics_tpu_torch_ckpt_generation",
)
_SERIES = (instrument.CKPT_BYTES, instrument.CKPT_SECONDS, instrument.CKPT_FAILURES, instrument.CKPT_GENERATION,
           instrument.CKPT_SKIPPED)


@pytest.fixture
def clean_ckpt_series():
    """Empty ckpt series and obs off before and after (the registry is global)."""
    obs.disable()
    for series in _SERIES:
        series.clear()
    yield
    obs.disable()
    for series in _SERIES:
        series.clear()


@pytest.fixture
def ckpt_activity_done(tmp_path, clean_ckpt_series):
    """One metric save+restore, one engine-writer commit, one absorbed failure."""
    obs.enable()
    m = BinaryAccuracy(device="cpu")
    m.update(torch.tensor([1, 0, 1]), torch.tensor([1, 1, 1]))
    path = str(tmp_path / "m.ckpt")
    m.save(path)
    BinaryAccuracy(device="cpu").restore(path)
    store = SnapshotStore(str(tmp_path / "store"), durable=False)
    w = AsyncCheckpointer(store, interval_s=0.0, site="engine")
    w.checkpoint_sync(lambda: ({"x": np.ones(4, np.float32)}, None))
    with DiskFull():
        w.checkpoint_sync(lambda: ({"x": np.ones(4, np.float32)}, None))
    w.close()
    return path


class TestPrometheusExposure:
    def test_ckpt_series_render(self, ckpt_activity_done):
        text = obs.REGISTRY.render_prometheus()
        parse_prometheus(text)  # grammar-valid exposition
        for family in _FAMILIES:
            assert f"# TYPE {family}" in text, family
        assert 'metrics_tpu_torch_ckpt_bytes_total{op="write",site="metric"}' in text
        assert 'metrics_tpu_torch_ckpt_bytes_total{op="restore",site="metric"}' in text
        assert 'metrics_tpu_torch_ckpt_generation{op="write",site="engine"} 0' in text
        assert 'metrics_tpu_torch_ckpt_failures_total{op="write",site="engine"} 1' in text

    def test_latency_histogram_counts_operations(self, ckpt_activity_done):
        assert instrument.CKPT_SECONDS.count(site="metric", op="write") == 1
        assert instrument.CKPT_SECONDS.count(site="metric", op="restore") == 1
        assert instrument.CKPT_SECONDS.count(site="engine", op="write") == 1


class TestJsonlExposure:
    def test_emit_includes_ckpt_families(self, ckpt_activity_done, tmp_path):
        path = str(tmp_path / "registry.jsonl")
        obs.REGISTRY.emit(path, run="ckpt-snapshot-test")
        record = [json.loads(ln) for ln in open(path)][0]
        reg = record["registry"]
        assert reg["metrics_tpu_torch_ckpt_bytes_total"]["type"] == "counter"
        values = reg["metrics_tpu_torch_ckpt_bytes_total"]["values"]
        assert "op=write,site=metric" in values and values["op=write,site=metric"] > 0
        assert reg["metrics_tpu_torch_ckpt_generation"]["values"]["op=write,site=engine"] == 0
        assert reg["metrics_tpu_torch_ckpt_seconds"]["values"]["op=write,site=metric"]["count"] == 1


class TestDisabledSilence:
    def test_ckpt_ops_record_nothing_when_obs_disabled(self, tmp_path, clean_ckpt_series):
        assert not obs.OBS.enabled
        m = BinaryAccuracy(device="cpu")
        m.update(torch.tensor([1, 0]), torch.tensor([1, 1]))
        path = str(tmp_path / "m.ckpt")
        m.save(path)
        BinaryAccuracy(device="cpu").restore(path)
        store = SnapshotStore(str(tmp_path / "store"), durable=False)
        w = AsyncCheckpointer(store, interval_s=0.0)
        w.checkpoint_sync(lambda: ({"x": np.ones(2)}, None))
        with DiskFull():
            w.checkpoint_sync(lambda: ({"x": np.ones(2)}, None))
        w.close()
        snap = obs.REGISTRY.snapshot()
        for family in _FAMILIES:
            assert snap[family]["values"] == {}, family
        text = obs.REGISTRY.render_prometheus()
        for family in _FAMILIES:
            assert family + "{" not in text, family

    def test_skipped_generations_are_counted_by_reason(self, tmp_path, clean_ckpt_series):
        from metrics_tpu_torch.ckpt import dumps
        from metrics_tpu_torch.ckpt.faults import tear

        obs.enable()
        store = SnapshotStore(str(tmp_path), durable=False)
        store.commit(dumps({"x": np.ones(2)}))
        store.commit(dumps({"x": np.ones(2)}))
        tear(store.path(1), frac=0.5)
        with pytest.warns(RuntimeWarning):
            assert store.latest_valid()[0] == 0
        assert instrument.CKPT_SKIPPED.value(reason="CorruptSnapshotError") == 1
