"""The tier plane (``metrics_tpu_torch/tier/`` and the engine's ``tier=``) against
the JAX package's, on the CPU.

Each case feeds the same numpy-seeded requests to a JAX engine, a tiered port
engine (``device="cpu"``) and, where it says so, an untiered port twin that
never demotes anyone. States must match leaf for leaf (``assert_trees_match``:
integer states bit for bit with their dtype, float states within rtol 1e-6);
entries (the host trees a demotion captures) must be equal array for array with
their dtype. The cases:

- demote → spill → readmit across window rotations, bit-identical to the twin
  and to the JAX engine, with reads of non-resident tenants (no readmission)
  equal to resident reads;
- freed slots reused before the slab grows (no new capture past the cap);
- ``register_tenants`` of 10^4 keys, ``tenant_tier`` and ``tier_stats`` against
  the JAX engine's along one script of operations;
- spill files and ``export_tenant`` entries read across both packages;
- the batched demotion (one gather per leaf for many tenants) equal to one
  demotion per tenant: the same entries, ``D`` records and free list.
"""

import time

import numpy as np
import pytest
import torch

import metrics_tpu.tier as jtier
import metrics_tpu_torch.tier as ttier
from metrics_tpu.engine import StreamingEngine as JaxEngine
from metrics_tpu.engine import TierConfig as JaxTierConfig
from metrics_tpu_torch.ckpt import RequestJournal
from metrics_tpu_torch.engine import CheckpointConfig, StreamingEngine, TierConfig
from metrics_tpu_torch.tier.residency import capture_entries, capture_entry
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from tests.test_torch_engine import (  # noqa: F401  (_one_torch_thread: the autouse fixture)
    FAMILIES,
    WAIT_S,
    _one_torch_thread,
    _flat,
    assert_trees_match,
    fold_rows,
)

KEYS = ("t0", "t1", "t2", "t3")
QUIET = dict(idle_demote_s=1000.0, check_interval_s=3600.0)  # only explicit demotions


def assert_entries_equal(got, want, what=""):
    """Two entries (or trees) equal array for array with their dtype: the
    structure, ``None`` rows and the rotation stamp included."""
    assert type(got) is type(want) or {type(got), type(want)} <= {list, tuple}, (what, type(got), type(want))
    if isinstance(want, dict):
        assert set(got) == set(want), (what, sorted(got), sorted(want))
        for k in want:
            assert_entries_equal(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_entries_equal(g, w, f"{what}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)):
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        assert got == want, (what, got, want)


def _feed(family, seed):
    gen = FAMILIES[family][2]
    rngs = {key: np.random.default_rng(seed + i) for i, key in enumerate(KEYS)}
    return lambda key: gen(rngs[key], int(rngs[key].integers(1, 5)))


def _close(*engines):
    for engine in engines:
        engine.close()


# --------------------------------------------------------------------------- bit identity


@pytest.mark.parametrize("family,window,spill", [
    ("binary_accuracy", None, False), ("binary_accuracy", 3, True), ("flagship", 3, False),
    ("quantile", None, True), ("mse", 2, False), ("heavy_hitters", 3, True),
])
def test_demote_and_readmit_across_rotations_is_bit_identical(family, window, spill, tmp_path):
    """A rotating victim is demoted each round (straight to disk with
    ``spill``), windows rotate mid-stream, every tenant is read while
    non-resident, then readmitted: the tiered engine equals its never-demoted
    twin and the tiered JAX engine, state for state and entry for entry."""
    make_jax, make_port, _ = FAMILIES[family]
    feed = _feed(family, 40)
    kw = dict(buckets=(8,), capacity=2, window=window)
    # the pass runs after every batch (for the spills); 4 tenants never reach the hot cap
    tier_kw = dict(hot_capacity=8, idle_demote_s=1000.0, check_interval_s=0.0)
    if spill:
        tier_kw.update(warm_capacity=0, spill_directory=str(tmp_path / "port-spill"))
    jtier_kw = dict(tier_kw, spill_directory=str(tmp_path / "jax-spill")) if spill else tier_kw
    tiered = StreamingEngine(make_port(), tier=TierConfig(**tier_kw), **kw)
    twin = StreamingEngine(make_port(), **kw)
    ref = JaxEngine(make_jax(), tier=JaxTierConfig(**jtier_kw), **kw)
    engines = (tiered, twin, ref)
    try:
        for round_no in range(6):
            for key in KEYS:
                args = feed(key)
                for engine in engines:
                    engine.submit(key, *args)
            for engine in engines:
                engine.flush(timeout=WAIT_S)
            if window is not None and round_no in (1, 3):
                for engine in engines:
                    engine.rotate_window()
            victim = KEYS[round_no % len(KEYS)]
            assert tiered.demote_tenant(victim) and ref.demote_tenant(victim)
            assert tiered.tenant_tier(victim) == ref.tenant_tier(victim) == "warm"
            if spill:  # the spill pass runs between batches: a tick on another tenant turns it
                tick = [k for k in KEYS if k != victim][0]
                args = feed(tick)
                for engine in engines:
                    engine.submit(tick, *args)
                    engine.flush(timeout=WAIT_S)
                deadline = time.monotonic() + WAIT_S
                while tiered.tenant_tier(victim) != "cold" and time.monotonic() < deadline:
                    time.sleep(0.01)
                assert tiered.tenant_tier(victim) == "cold"
            # a read of a non-resident tenant neither promotes it nor differs
            for win in ((False, True) if window else (False,)):
                assert_trees_match(tiered.compute(victim, window=win), twin.compute(victim, window=win), victim)
            assert tiered.tenant_tier(victim) in ("warm", "cold")
        for key in KEYS:
            tiered.pin_tenant(key)
            ref.pin_tenant(key)
        for key in KEYS:
            assert_trees_match(tiered._keyed.state_of(key), twin._keyed.state_of(key), f"{key} vs twin")
            assert_trees_match(tiered._keyed.state_of(key), ref._keyed.state_of(key), f"{key} vs JAX")
            assert_entries_equal(capture_entry(tiered._keyed, key), capture_entry(twin._keyed, key), key)
            port_entry = capture_entry(tiered._keyed, key)
            jax_entry = jtier.capture_entry(ref._keyed, key)
            assert _flat(port_entry["state"]).keys() == _flat(jax_entry["state"]).keys()
            assert_trees_match(port_entry, jax_entry, f"{key} entry vs JAX")
            if window:
                assert_trees_match(tiered.compute(key, window=True), twin.compute(key, window=True), key)
        snap = tiered.telemetry_snapshot()
        assert snap["tier_demotions"] == 6 and snap["tier_promotions"] >= 6
        assert snap["tier_spills"] == (6 if spill else 0)
    finally:
        _close(*engines)


def test_a_submit_to_a_demoted_tenant_promotes_it_in_place():
    """The promoted entry lands in a slab row of the existing slab tensors (the
    ones captured graphs read on the card), and the next micro-batch reads it."""
    tiered = StreamingEngine(FAMILIES["binary_accuracy"][1](), buckets=(8,), capacity=4,
                             tier=TierConfig(hot_capacity=8, **QUIET))
    try:
        feed = _feed("binary_accuracy", 3)
        stream = [(key, feed(key)) for key in KEYS for _ in range(3)]
        for key, args in stream[:6]:
            tiered.submit(key, *args)
        tiered.flush(timeout=WAIT_S)
        leaves = [leaf.data_ptr() for leaf in tiered._keyed.leaves()]
        assert tiered.demote_tenant("t0")
        for key, args in stream[6:]:
            tiered.submit(key, *args)
        tiered.submit("t0", *stream[0][1])
        tiered.flush(timeout=WAIT_S)
        assert [leaf.data_ptr() for leaf in tiered._keyed.leaves()] == leaves
        assert tiered.tenant_tier("t0") == "hot"
        folds = fold_rows(FAMILIES["binary_accuracy"][1](), stream + [stream[0]])
        for key, fold in folds.items():
            assert_trees_match(tiered._keyed.state_of(key), fold, key)
    finally:
        tiered.close()


# --------------------------------------------------------------------------- the free list and the cap


def _settle(engine, cap):
    engine.flush(timeout=WAIT_S)
    deadline = time.monotonic() + WAIT_S
    while engine.tier_stats()["hot"] > cap and time.monotonic() < deadline:
        time.sleep(0.005)


def test_freed_slots_are_reused_before_the_slab_grows():
    """A sweep over 40 tenants with a hot set of 4: the eviction pass demotes
    the coldest between batches and their rows go to new tenants, so the slab
    stays at 8 rows and no micro-batch kernel is built past that capacity;
    every tenant (all but the hot few now warm) holds its fold."""
    cap = 4
    engine = StreamingEngine(FAMILIES["binary_accuracy"][1](), buckets=(8,), capacity=4,
                             tier=TierConfig(hot_capacity=cap, idle_demote_s=1000.0, check_interval_s=0.0))
    try:
        rng = np.random.default_rng(5)
        stream = [(f"s{i}", (rng.integers(0, 2, 2), rng.integers(0, 2, 2))) for i in range(40)]
        for i in range(0, len(stream), 2):
            for key, args in stream[i : i + 2]:
                engine.submit(key, *args)
            _settle(engine, cap)
        stats = engine.tier_stats()
        assert stats["hot"] <= cap and stats["hot"] + stats["warm"] == 40
        assert engine._keyed.capacity <= 8 and max(engine._keyed._slots.values()) < 8
        snap = engine.telemetry_snapshot()
        assert snap["key_growths"] <= 1 and snap["compiles"] <= 2
        assert snap["tier_demotions"] == 40 - stats["hot"]
        for key, fold in fold_rows(FAMILIES["binary_accuracy"][1](), stream).items():
            assert_trees_match(engine._read_states([key], False)[key], fold, key)
    finally:
        engine.close()


def test_concurrent_clients_against_the_eviction_pass_lose_no_row():
    """Four client threads over 40 tenants with a hot set of 4, the pass
    running after every batch and the interpreter switching threads every
    10 µs: submits race demotions and promotions (a slot allocated for a key
    whose state sits in the warm mirror, a slot freed under a queued
    request), and every tenant still holds its fold, resident or not."""
    import sys
    import threading

    engine = StreamingEngine(FAMILIES["binary_accuracy"][1](), buckets=(8, 32), capacity=4,
                             tier=TierConfig(hot_capacity=4, idle_demote_s=1000.0, check_interval_s=0.0))
    rng = np.random.default_rng(17)
    stream = [(f"c{int(rng.integers(0, 40))}", (rng.integers(0, 2, 3), rng.integers(0, 2, 3))) for _ in range(400)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=lambda part=stream[i::4]: [engine.submit(k, *a) for k, a in part])
                   for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(WAIT_S)
            assert not th.is_alive()
        engine.flush(timeout=WAIT_S)
        snap = engine.telemetry_snapshot()
        assert snap["failed"] == 0 and snap["processed"] == len(stream) and snap["tier_demotions"] > 0
        folds = fold_rows(FAMILIES["binary_accuracy"][1](), stream)
        states = engine._read_states(list(folds), False)
        for key, fold in folds.items():
            assert_trees_match(states[key], fold, key)
    finally:
        sys.setswitchinterval(interval)
        engine.close()


def test_pinned_tenants_are_never_demoted():
    engine = StreamingEngine(FAMILIES["binary_accuracy"][1](), buckets=(8,), capacity=4,
                             tier=TierConfig(hot_capacity=2, idle_demote_s=1000.0, check_interval_s=0.0))
    try:
        engine.submit("pinned", np.array([1]), np.array([1]))
        engine.flush(timeout=WAIT_S)
        engine.pin_tenant("pinned")
        for i in range(8):
            engine.submit(f"x{i}", np.array([1]), np.array([0]))
            _settle(engine, 2)
        assert engine.tenant_tier("pinned") == "hot"
        assert engine.demote_tenant("pinned") is False
        engine.unpin_tenant("pinned")
        assert engine.demote_tenant("pinned") is True
        engine.pin_tenant("pinned")  # promotes at once
        assert engine.tenant_tier("pinned") == "hot" and float(engine.compute("pinned")) == 1.0
    finally:
        engine.close()


# --------------------------------------------------------------------------- registration and residency


def test_register_ten_thousand_tenants_as_jax_does():
    n = 10_000
    port = StreamingEngine(FAMILIES["binary_accuracy"][1](), buckets=(8,), capacity=8,
                           tier=TierConfig(hot_capacity=64, **QUIET))
    ref = JaxEngine(FAMILIES["binary_accuracy"][0](), buckets=(8,), capacity=8,
                    tier=JaxTierConfig(hot_capacity=64, **QUIET))
    try:
        keys = [f"reg-{i}" for i in range(n)]
        slab = port.tier_stats()["slab_bytes"]
        assert port.register_tenants(keys) == ref.register_tenants(keys) == n
        assert port.register_tenants(keys[:10]) == ref.register_tenants(keys[:10]) == 0
        assert port.tier_stats() == ref.tier_stats()
        assert port.tier_stats()["slab_bytes"] == slab and port.tier_stats()["cold"] == n
        rng = np.random.default_rng(9)
        reqs = [(keys[int(rng.integers(0, n))], (rng.integers(0, 2, 3), rng.integers(0, 2, 3))) for _ in range(30)]
        for engine in (port, ref):
            for key, args in reqs:
                engine.submit(key, *args)
            engine.flush(timeout=WAIT_S)
        assert port.tier_stats() == ref.tier_stats()
        assert port.telemetry_snapshot()["tenants"] == ref.telemetry_snapshot()["tenants"] == n
        for key in {k for k, _ in reqs} | set(keys[:3]):
            assert port.tenant_tier(key) == ref.tenant_tier(key)
            assert_trees_match(port.compute(key), ref.compute(key), key)
        with pytest.raises(MetricsTPUUserError, match="tier=TierConfig"):
            StreamingEngine(FAMILIES["binary_accuracy"][1](), start=False).register_tenants(["a"])
    finally:
        _close(port, ref)


def test_tenant_tier_and_tier_stats_follow_jax_along_a_script(tmp_path):
    ops = [("submit", "a"), ("submit", "b"), ("submit", "c"), ("demote", "a"), ("register", "d"),
           ("pin", "a"), ("demote", "a"), ("unpin", "a"), ("demote", "a"), ("submit", "d"), ("evict", "b"),
           ("evict", "zzz"), ("demote", "c"), ("submit", "c"), ("register", "c"), ("evict", "d"),
           ("demote", "nobody"), ("reset", None), ("submit", "a")]
    port = StreamingEngine(FAMILIES["binary_accuracy"][1](), buckets=(8,),
                           tier=TierConfig(hot_capacity=8, **QUIET))
    ref = JaxEngine(FAMILIES["binary_accuracy"][0](), buckets=(8,), tier=JaxTierConfig(hot_capacity=8, **QUIET))
    rng = np.random.default_rng(2)
    try:
        for op, key in ops:
            args = (rng.integers(0, 2, 2), rng.integers(0, 2, 2))
            results = []
            for engine in (port, ref):
                if op == "submit":
                    engine.submit(key, *args).result(timeout=WAIT_S)
                    result = None
                elif op == "demote":
                    result = engine.demote_tenant(key)
                elif op == "register":
                    result = engine.register_tenants([key])
                elif op == "pin":
                    result = engine.pin_tenant(key)
                elif op == "unpin":
                    result = engine.unpin_tenant(key)
                elif op == "evict":
                    result = engine.evict_tenant(key)
                else:
                    result = engine.reset()
                engine.flush(timeout=WAIT_S)
                results.append((result, {k: engine.tenant_tier(k) for k in "abcd"}, engine.tier_stats()))
            assert results[0] == results[1], (op, key, results)
        for key, value in ref.compute_all().items():
            assert_trees_match(port.compute_all()[key], value, key)
    finally:
        _close(port, ref)


# --------------------------------------------------------------------------- entries across the packages


def _served_pair(window=3):
    make_jax, make_port, _ = FAMILIES["flagship"]
    feed = _feed("flagship", 70)
    port = StreamingEngine(make_port(), buckets=(8,), window=window, tier=TierConfig(hot_capacity=8, **QUIET))
    ref = JaxEngine(make_jax(), buckets=(8,), window=window, tier=JaxTierConfig(hot_capacity=8, **QUIET))
    for round_no in range(4):
        for key in KEYS:
            args = feed(key)
            for engine in (port, ref):
                engine.submit(key, *args)
        for engine in (port, ref):
            engine.flush(timeout=WAIT_S)
            if round_no == 1:
                engine.rotate_window()
    return port, ref


def test_spill_files_read_in_both_packages(tmp_path):
    port, ref = _served_pair()
    try:
        for key in KEYS[:2]:
            port_entry, jax_entry = port.export_tenant(key, retire=False), ref.export_tenant(key, retire=False)
            name, _ = ttier.ColdStore(str(tmp_path / "from-port"), durable=False).spill(key, port_entry)
            read_by_jax = jtier.ColdStore(str(tmp_path / "from-port")).load(name)
            assert_entries_equal(read_by_jax, port_entry, f"{key} port file in JAX")
            name, _ = jtier.ColdStore(str(tmp_path / "from-jax"), durable=False).spill(key, jax_entry)
            read_by_port = ttier.ColdStore(str(tmp_path / "from-jax")).load(name)
            assert_trees_match(read_by_port, port_entry, f"{key} JAX file in the port")
    finally:
        _close(port, ref)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_exported_entries_import_in_the_other_package(direction):
    """A tenant exported (and retired) by one package's engine and imported by
    the other's holds the same live state and window rows as it had."""
    port, ref = _served_pair()
    make_jax, make_port, _ = FAMILIES["flagship"]
    sink_port = StreamingEngine(make_port(), buckets=(8,), window=3)
    sink_jax = JaxEngine(make_jax(), buckets=(8,), window=3)
    try:
        for key in KEYS:
            src, dst = (ref, sink_port) if direction == "jax_to_port" else (port, sink_jax)
            want = capture_entry(port._keyed, key) if direction == "port_to_jax" else None
            entry = src.export_tenant(key)
            assert src.tenant_tier(key) is None
            dst.import_tenant(key, entry)
            got = (capture_entry(sink_port._keyed, key) if direction == "jax_to_port"
                   else jtier.capture_entry(sink_jax._keyed, key))
            assert_trees_match(got["state"], entry["state"], key)
            assert len(got["ring"]) == len(entry["ring"])
            for g, w in zip(got["ring"], entry["ring"]):
                assert (g is None) == (w is None)
                if w is not None:
                    assert_trees_match(g, w, key)
            if want is not None:
                assert_entries_equal(entry, want, key)
        assert port.telemetry_snapshot()["tenants"] + ref.telemetry_snapshot()["tenants"] == len(KEYS)
    finally:
        _close(port, ref, sink_port, sink_jax)


# --------------------------------------------------------------------------- batched demotion


def _wal(directory):
    journal = RequestJournal(str(directory), durable=False)
    try:
        return [payload for _, payload in journal.replay()]
    finally:
        journal.close()


@pytest.mark.parametrize("family,window", [("flagship", 3), ("quantile", None), ("mse", 2)])
def test_batched_demotion_equals_one_demotion_per_tenant(family, window, tmp_path):
    """Demoting many tenants in one gather per leaf gives the entries, the D
    records, the free list and the slab that one demotion per tenant gives;
    the JAX engine's per-tenant demotions capture the same entries."""
    make_jax, make_port, _ = FAMILIES[family]
    feed = _feed(family, 90)
    kw = dict(buckets=(8,), capacity=2, window=window)
    engines = [StreamingEngine(make_port(), tier=TierConfig(hot_capacity=16, **QUIET),
                               checkpoint=CheckpointConfig(directory=str(tmp_path / name), interval_s=3600.0,
                                                           durable=False), **kw)
               for name in ("batched", "single")]
    ref = JaxEngine(make_jax(), tier=JaxTierConfig(hot_capacity=16, **QUIET), **kw)
    keys = [f"d{i}" for i in range(7)]
    try:
        for round_no in range(3):
            for i, key in enumerate(keys):
                args = feed(KEYS[i % 4])
                for engine in (*engines, ref):
                    engine.submit(key, *args)
            for engine in (*engines, ref):
                engine.flush(timeout=WAIT_S)
                if window and round_no == 1:
                    engine.rotate_window()
        victims = ["d5", "d1", "d6", "d3"]
        batched, single = engines
        assert capture_entries(batched._keyed, victims)[0]["rot"] == batched._keyed.rotations
        with batched._dispatch_lock, batched._on_stream():
            assert batched._demote_tenants(victims) == len(victims)
        with single._dispatch_lock, single._on_stream():
            for key in victims:
                assert single._demote_tenant(key)
        with ref._dispatch_lock:
            for key in victims:
                assert ref._demote_tenant(key)
        assert list(batched._tier.warm) == list(single._tier.warm) == victims
        for key in victims:
            assert_entries_equal(batched._tier.warm[key], single._tier.warm[key], key)
            assert_trees_match(batched._tier.warm[key], ref._tier.warm[key], f"{key} vs JAX")
        assert batched._keyed._free_slots == single._keyed._free_slots
        assert batched._keyed._slots == single._keyed._slots
        for a, b in zip(batched._slab_leaves(), single._slab_leaves()):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert batched.telemetry_snapshot()["tier_demotions"] == len(victims)
        for engine in engines:
            engine.close(checkpoint=False)
        # the traffic's chunk records depend on how each dispatcher drained; the
        # tier records must be the same records in the same order
        records = [[r for r in _wal(tmp_path / name) if r[:1] in (b"D", b"P", b"T")] for name in ("batched", "single")]
        assert records[0] == records[1] and [r[:1] for r in records[0]] == [b"D"] * len(victims)
    finally:
        _close(*engines, ref)


def test_tier_config_matches_jax():
    want, got = JaxTierConfig(), TierConfig()
    fields = [f for f in want.__dataclass_fields__ if f != "clock"]
    assert list(got.__dataclass_fields__) == list(want.__dataclass_fields__)
    assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}
    for kwargs in ({"hot_capacity": 0}, {"warm_capacity": -1}, {"warm_capacity": 4}, {"idle_demote_s": 0.0},
                   {"check_interval_s": -1.0}):
        for cls in (JaxTierConfig, TierConfig):
            with pytest.raises(Exception, match="tier"):
                cls(**kwargs)
    assert sorted(ttier.__all__) == sorted(jtier.__all__)
