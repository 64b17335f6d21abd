"""The port's keyed state (``metrics_tpu_torch/engine/stream.py``) against the JAX
package's, on the CPU: slot allocation (above the max id, gapped installs, the
free list), capacity doubling, windows against brute-force recomputes and
against the JAX engine, eviction, and the slab-address invariant the captured
graphs rely on (only a growth makes new slab tensors). Integer states are
compared bit for bit with their dtype, float states within rtol 1e-6
(``tests/test_torch_engine.py``)."""

import jax
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten

import metrics_tpu_torch.classification as tcls
from metrics_tpu.engine import KeyedState as JaxKeyedState
from metrics_tpu.engine import StreamingEngine as JaxEngine
from metrics_tpu_torch.engine import EagerKeyedState, KeyedState, StreamingEngine
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from metrics_tpu_torch.utils.params_io import keyed_state_from_jax
from tests.test_torch_engine import (  # noqa: F401  (_one_torch_thread: the autouse fixture)
    CPU,
    FAMILIES,
    WAIT_S,
    _one_torch_thread,
    _scores,
    _stream,
    assert_engines_match,
    assert_trees_match,
    run_stream,
)


def _port(family):
    return FAMILIES[family][1]()


def _jax(family):
    return FAMILIES[family][0]()


def _ptrs(keyed):
    return [leaf.data_ptr() for leaf in keyed.leaves()]


# --------------------------------------------------------------------------- slots and growth


def test_capacity_growth_preserves_state():
    """Capacity 2, seven tenants: every tenant's state equals the JAX engine's
    across the doublings (2 -> 4 -> 8)."""
    stream = _stream(FAMILIES["accuracy"][2], seed=0, n=40, keys=7, max_rows=2)
    ref = JaxEngine(_jax("accuracy"), buckets=(8,), capacity=2)
    port = StreamingEngine(_port("accuracy"), buckets=(8,), capacity=2)
    try:
        run_stream(ref, stream)
        run_stream(port, stream)
        assert port._keyed.capacity == ref._keyed.capacity == 8
        assert port.telemetry_snapshot()["key_growths"] >= 1
        assert_engines_match(port, ref)
    finally:
        port.close()
        ref.close()


def test_keyed_state_fresh_key_reads_init():
    ks, ref = KeyedState(_port("accuracy"), capacity=1), JaxKeyedState(_jax("accuracy"), capacity=1)
    for keyed in (ks, ref):
        keyed.slot_for("a")
        keyed.slot_for("b")  # slot 1 >= capacity until a dispatch grows the stack
    state = ks.state_of("b")
    assert int(state["tp"].sum()) == 0 and int(state["_update_count"]) == 0
    assert_trees_match(state, ref.state_of("b"))


def test_keyed_state_allocation_skips_installed_gaps():
    ks, ref = KeyedState(_port("accuracy"), capacity=8), JaxKeyedState(_jax("accuracy"), capacity=8)
    for keyed in (ks, ref):
        keyed.install_slot("a", 0)
        keyed.install_slot("b", 5)  # installed with a gap
        keyed.ensure_capacity()
        assert keyed.capacity >= 6
    fresh = [ks.slot_for(k) for k in ("c", "d", "e", "f")]
    assert fresh == [ref.slot_for(k) for k in ("c", "d", "e", "f")]
    assert len(set(ks._slots.values())) == len(ks._slots), "slot id collision"
    assert all(s > 5 for s in fresh)
    assert ks.install_slot("b", 7) == 5  # a setdefault: the first id stays


def test_released_slots_are_reused_first_like_jax():
    ks, ref = KeyedState(_port("accuracy"), capacity=4), JaxKeyedState(_jax("accuracy"), capacity=4)
    for keyed in (ks, ref):
        for k in ("a", "b", "c"):
            keyed.slot_for(k)
        keyed.release_slot(keyed.evict("b"))
        keyed.release_slot(keyed.evict("b"))  # unknown now: a no-op
    assert ks.slot_for("d") == ref.slot_for("d") == 1
    assert ks.slot_for("e") == ref.slot_for("e") == 3


def test_grow_keeps_mixed_dtypes_and_rows():
    """Mixed-dtype state (MeanMetric: float32 sums, int32 update count): old rows
    bit-identical after the growth, new rows init, dtypes kept."""
    m = _port("mean")
    ks = KeyedState(m, capacity=2)
    before = ks.leaves()
    assert len({leaf.dtype for leaf in before}) >= 2
    ks.slot_for("a")
    ks.set_state("a", m.update_state(m.init_state(), torch.tensor([1.0, 3.0])))
    reference = ks.state_of("a")
    for i in range(5):
        ks.slot_for(f"extra-{i}")
    assert ks.ensure_capacity() is True and ks.capacity == 8
    assert_trees_match(ks.state_of("a"), reference)
    assert_trees_match(ks.state_of("extra-4"), m.init_state())
    for leaf, old in zip(ks.leaves(), before):
        assert leaf.dtype == old.dtype and leaf.shape[0] == 8


def test_grow_records_wall_time_and_engine_telemetry_counts_it():
    ks = KeyedState(_port("accuracy"), capacity=1)
    assert ks.last_resize_s == 0.0
    ks.slot_for("a")
    ks.slot_for("b")
    assert ks.ensure_capacity() and ks.last_resize_s > 0.0
    engine = StreamingEngine(_port("accuracy"), buckets=(8,), capacity=1)
    try:
        for i in range(4):
            engine.submit(f"k{i}", np.array([1], np.int32), np.array([1], np.int32))
        engine.flush(timeout=WAIT_S)
        snap = engine.telemetry_snapshot()
        assert snap["key_growths"] >= 1 and snap["resize_seconds"] > 0.0
    finally:
        engine.close()


def test_writes_keep_the_slab_tensors():
    """set_state, evict, rotate and reset write the slab in place (a captured
    graph is bound to its addresses); only ensure_capacity makes new tensors."""
    m = _port("accuracy")
    ks = KeyedState(m, capacity=2, window=3)
    ks.slot_for("a")
    ptrs = _ptrs(ks)
    ks.set_state("a", m.update_state(m.init_state(), torch.tensor([1]), torch.tensor([1])))
    ks.rotate()
    ks.reset()
    ks.evict("a")
    assert _ptrs(ks) == ptrs
    for k in ("b", "c", "d"):
        ks.slot_for(k)
    assert ks.ensure_capacity() and _ptrs(ks) != ptrs


def test_state_of_is_a_copy():
    m = _port("accuracy")
    ks = KeyedState(m, capacity=2)
    ks.slot_for("a")
    snapshot = ks.state_of("a")
    ks.set_state("a", m.update_state(m.init_state(), torch.tensor([2]), torch.tensor([2])))
    assert int(snapshot["_update_count"]) == 0 and int(ks.state_of("a")["_update_count"]) == 1


def test_state_layout_must_match_the_slab():
    ks = KeyedState(_port("accuracy"), capacity=2)
    ks.slot_for("a")
    state = ks.state_of("a")
    with pytest.raises(ValueError, match="layout"):
        ks.set_state("a", dict(reversed(list(state.items()))))


# --------------------------------------------------------------------------- eviction


def test_keyed_state_evict_scrubs_live_row_and_burns_slot():
    m = _port("accuracy")
    ks = KeyedState(m, capacity=4)
    slot_a = ks.slot_for("a")
    ks.set_state("a", m.update_state(m.init_state(), torch.tensor([1]), torch.tensor([1])))
    ks.evict("a")
    assert "a" not in ks.keys
    assert all(int(leaf[slot_a].sum()) == 0 for leaf in ks.leaves())
    assert ks.slot_for("a") != slot_a  # never reused without release_slot
    assert ks.evict("never-registered") is None


def test_release_slot_scrubs_the_window_ring():
    m = _port("accuracy")
    ks = KeyedState(m, capacity=4, window=3)
    slot = ks.slot_for("a")
    ks.set_state("a", m.update_state(m.init_state(), torch.tensor([1]), torch.tensor([1])))
    ks.rotate()
    ks.release_slot(ks.evict("a"))
    assert ks.slot_for("new") == slot
    assert int(ks.merged_state("new")["_update_count"]) == 0  # nothing inherited


def test_eager_keyed_state_evict_scrubs_window_ring():
    m = tcls.BinaryAUROC(thresholds=None, **CPU)
    ks = EagerKeyedState(m, window=3)
    ks.slot_for("a")
    ks.update("a", torch.tensor([0.8, 0.2]), torch.tensor([1, 0]))
    ks.rotate()
    ks.update("a", torch.tensor([0.6]), torch.tensor([1]))
    ks.evict("a")
    assert "a" not in ks.keys and all("a" not in seg for seg in ks._ring)


# --------------------------------------------------------------------------- windows


@pytest.mark.parametrize("family", ["accuracy", "quantile", "auroc"])
def test_sliding_window_matches_jax(family):
    """window=3 over six segments: after each rotation the windowed and the live
    value equal the JAX engine's (merge of the surviving ring segments)."""
    gen = FAMILIES[family][2]
    rng = np.random.default_rng(42)
    ref = JaxEngine(_jax(family), buckets=(8,), window=3, capacity=2)
    port = StreamingEngine(_port(family), buckets=(8,), window=3, capacity=2)
    try:
        for seg in range(6):
            if seg:
                ref.rotate_window()
                port.rotate_window()
            stream = [("w", gen(rng, 3)) for _ in range(3)]
            run_stream(ref, stream)
            run_stream(port, stream)
            assert_trees_match(port.compute("w", window=True), ref.compute("w", window=True), f"segment {seg}")
            assert_trees_match(port._keyed.merged_state("w"), ref._keyed.merged_state("w"), f"segment {seg}")
        assert_trees_match(port.compute("w"), ref.compute("w"))
        assert port.telemetry_snapshot()["window_rotations"] == 5
    finally:
        port.close()
        ref.close()


def _window_oracle(segments):
    m = tcls.BinaryAUROC(thresholds=None, **CPU)
    for seg in segments:
        for p, t in seg:
            m.update(torch.from_numpy(p), torch.from_numpy(t))
    return float(m.compute())


def test_sliding_window_on_the_eager_path_vs_brute_force():
    """The exact AUROC serves eagerly; its window equals a recompute over the last
    three segments' raw data."""
    rng = np.random.default_rng(7)
    engine = StreamingEngine(tcls.BinaryAUROC(thresholds=None, **CPU), window=3)
    try:
        assert not engine.fused
        segments = []
        for seg_idx in range(5):
            if seg_idx:
                engine.rotate_window()
            seg = [_scores(rng, 3) for _ in range(3)]
            run_stream(engine, [("w", s) for s in seg])
            segments.append(seg)
            assert float(engine.compute("w", window=True)) == pytest.approx(_window_oracle(segments[-3:]), abs=1e-6)
    finally:
        engine.close()


def test_window_one_is_reset_per_segment():
    engine = StreamingEngine(_port("accuracy"), buckets=(8,), window=1)
    try:
        engine.submit("k", np.array([1], np.int32), np.array([0], np.int32))
        engine.rotate_window()
        engine.submit("k", np.array([1], np.int32), np.array([1], np.int32))
        assert float(engine.compute("k", window=True)) == 1.0
    finally:
        engine.close()


def test_rotate_without_window_raises():
    engine = StreamingEngine(_port("accuracy"), buckets=(8,))
    try:
        with pytest.raises(MetricsTPUUserError, match="window"):
            engine.rotate_window()
        engine.submit("k", np.array([1], np.int32), np.array([1], np.int32))
        with pytest.raises(MetricsTPUUserError, match="window"):
            engine.compute("k", window=True)
    finally:
        engine.close()
    with pytest.raises(MetricsTPUUserError, match="window"):
        KeyedState(_port("accuracy"), window=0)


def test_window_key_absent_from_old_segments():
    """A tenant first seen after a rotation (and a growth) does not break the
    merge over a ring that predates it."""
    ref = JaxEngine(_jax("mean"), buckets=(8,), window=3, capacity=1)
    port = StreamingEngine(_port("mean"), buckets=(8,), window=3, capacity=1)
    try:
        for engine in (ref, port):
            engine.submit("old", np.array([1.0], np.float32))
            engine.rotate_window()
            engine.submit("new", np.array([2.0], np.float32))
            engine.flush(timeout=WAIT_S)
        for key in ("old", "new"):
            assert_trees_match(port.compute(key, window=True), ref.compute(key, window=True), key)
    finally:
        port.close()
        ref.close()


def test_engine_reset_clears_all_tenants():
    engine = StreamingEngine(_port("accuracy"), buckets=(8,))
    try:
        engine.submit("a", np.array([1], np.int32), np.array([1], np.int32))
        engine.flush(timeout=WAIT_S)
        compiles = engine.telemetry_snapshot()["compiles"]
        engine.reset()
        state = engine._keyed.state_of("a")
        assert int(state["tp"].sum()) == 0 and int(state["_update_count"]) == 0
        engine.submit("a", np.array([1, 1], np.int32), np.array([1, 0], np.int32))
        engine.flush(timeout=WAIT_S)
        assert float(engine.compute("a")) == 0.5
        assert engine.telemetry_snapshot()["compiles"] == compiles  # the kernel survived the reset
    finally:
        engine.close()


# --------------------------------------------------------------------------- state carried across


@pytest.mark.parametrize("source", ["per_key", "slab"])
@pytest.mark.parametrize("family", ["flagship", "heavy_hitters"])
def test_jax_engine_states_load_at_the_same_slots(family, source):
    """A JAX engine's tenants (as numpy) load into a port KeyedState at the same
    slot ids; fed the same next requests, both engines then agree."""
    gen = FAMILIES[family][2]
    ref = JaxEngine(_jax(family), buckets=(8,), capacity=2)
    port = StreamingEngine(_port(family), buckets=(8,), capacity=2)
    try:
        run_stream(ref, _stream(gen, seed=3, n=12, keys=3, max_rows=3))
        slots = dict(ref._keyed._slots)
        if source == "per_key":
            states = {k: jax.device_get(ref._keyed.state_of(k)) for k in slots}
            keyed_state_from_jax(port._keyed, slots, states=states)
        else:
            keyed_state_from_jax(port._keyed, slots, stacked=jax.device_get(ref._keyed.stacked))
        assert port._keyed._slots == slots
        assert_engines_match(port, ref)
        more = _stream(gen, seed=4, n=10, keys=4, max_rows=3)
        run_stream(ref, more)
        run_stream(port, more)
        assert_engines_match(port, ref)
    finally:
        port.close()
        ref.close()


def test_loader_takes_exactly_one_source():
    with pytest.raises(ValueError, match="exactly one"):
        keyed_state_from_jax(KeyedState(_port("accuracy")), {"a": 0})


def test_tree_leaves_follow_init_state():
    """The slab's leaves follow ``init_state``'s layout (the captured scan matches a
    new state's leaves to the slab's by position)."""
    m = _port("flagship")
    ks = KeyedState(m, capacity=2)
    assert [tuple(leaf.shape[1:]) for leaf in ks.leaves()] == [tuple(x.shape) for x in tree_flatten(m.init_state())[0]]
