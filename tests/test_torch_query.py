"""The port's query plane (``metrics_tpu_torch/query/``) and the engine's
``rollup`` against the JAX package's, on the CPU (twins of ``tests/query/``).

Both packages fold the same numpy-seeded tenant states: integer leaves (every
sketch's buckets, registers, tables and ledgers, and ``_update_count``) must
be bit-identical with their int32 dtype, float leaves within rtol 1e-6 across
packages (and exact within the port where the reduction is). The global
query runs over a stand-in partitioned client: partition *i* is one engine,
every read is a leader read, as in ``chip_smoke.py`` Phase S. The partition
plane's own client (``PartitionedClient``, with followers and the coordination
store) is not ported yet (ROADMAP A.9b), so one JAX-side case shows that the
stand-in gives the JAX ``GlobalQuery`` the same answer and report as that
client over the same engines.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.engine as jeng
import metrics_tpu.query as jq
import metrics_tpu.sketch as jsk
import metrics_tpu_torch as tm
import metrics_tpu_torch.sketch as tsk
from metrics_tpu.metric import Metric as JaxMetric
from metrics_tpu.metric import zero_state as jax_zero_state
from metrics_tpu_torch import obs
from metrics_tpu_torch import query as tq
from metrics_tpu_torch.ckpt.store import RequestJournal
from metrics_tpu_torch.engine import CheckpointConfig, EngineClosed, StreamingEngine, TierConfig
from metrics_tpu_torch.metric import Metric, zero_state
from metrics_tpu_torch.shard import HashRing
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from tests.test_torch_engine import _one_torch_thread, assert_trees_match  # noqa: F401  (the autouse fixture)

CPU = {"device": "cpu"}
P = 4


def assert_states_equal(a, b, what=""):
    """Exact equality, leaf for leaf, dtypes included (within one package)."""
    assert set(a) == set(b), (what, set(a), set(b))
    for name in a:
        x, y = torch.as_tensor(a[name]), torch.as_tensor(b[name])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, name, x.dtype, y.dtype)
        assert torch.equal(x, y) or bool(torch.all((x == y) | (torch.isnan(x) & torch.isnan(y)))), (what, name)


class _AvgState(Metric):
    """A ``dist_reduce_fx="mean"`` state (image-metric style), states fabricated."""

    full_state_update = False

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("avg", zero_state((), torch.float32, device=self.device), dist_reduce_fx="mean")

    def update(self, v):  # pragma: no cover - states are fabricated
        self.avg = v

    def compute(self):
        return self.avg


class _JaxAvgState(JaxMetric):
    full_state_update = False

    def __init__(self):
        super().__init__()
        self.add_state("avg", jax_zero_state((), jnp.float32), dist_reduce_fx="mean")

    def update(self, v):  # pragma: no cover - states are fabricated
        self.avg = v

    def compute(self):
        return self.avg


# family -> (JAX metric, port metric, batch draw); one batch length a family, so
# the JAX package's eager updates compile once
FAMILIES = {
    "ddsketch": (lambda: jsk.QuantileSketch(quantiles=(0.5, 0.99)), lambda: tsk.QuantileSketch(quantiles=(0.5, 0.99), **CPU),
                 lambda rng: rng.lognormal(0.0, 2.0, 8).astype(np.float32)),
    "hll": (lambda: jsk.CardinalitySketch(p=5), lambda: tsk.CardinalitySketch(p=5, **CPU),
            lambda rng: rng.integers(0, 10_000, 12).astype(np.int32)),
    "cms": (lambda: jsk.HeavyHittersSketch(k=24, depth=2, width=32), lambda: tsk.HeavyHittersSketch(k=24, depth=2, width=32, **CPU),
            lambda rng: rng.integers(0, 24, 10).astype(np.int32)),
    "sum": (jm.SumMetric, lambda: tm.SumMetric(**CPU), lambda rng: rng.integers(-50, 50, 6).astype(np.float32)),
    "mean": (jm.MeanMetric, lambda: tm.MeanMetric(**CPU), lambda rng: rng.random(4).astype(np.float32)),
    "max": (jm.MaxMetric, lambda: tm.MaxMetric(**CPU), lambda rng: rng.normal(size=4).astype(np.float32)),
    "min": (jm.MinMetric, lambda: tm.MinMetric(**CPU), lambda rng: rng.normal(size=4).astype(np.float32)),
}
EXACT = ("ddsketch", "hll", "cms", "sum", "max", "min")


def _tenant_states(metric, batches, to):
    states = []
    for tenant in batches:
        s = metric.init_state()
        for batch in tenant:
            s = metric.update_state(s, to(batch))
        states.append(s)
    return states


def _both_states(family, n, seed, batches_per=2):
    make_jax, make_port, draw = FAMILIES[family]
    rng = np.random.default_rng(seed)
    batches = [[draw(rng) for _ in range(int(rng.integers(1, batches_per + 1)))] for _ in range(n)]
    jmetric, tmetric = make_jax(), make_port()
    return (jmetric, _tenant_states(jmetric, batches, jnp.asarray),
            tmetric, _tenant_states(tmetric, batches, torch.from_numpy))


def _port_states(family, n, seed):
    _, make_port, draw = FAMILIES[family]
    rng = np.random.default_rng(seed)
    metric = make_port()
    return metric, _tenant_states(metric, [[draw(rng)] for _ in range(n)], torch.from_numpy)


# ------------------------------------------------------------------------ folds


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fold_equals_jax_and_the_pairwise_merge(family):
    jmetric, jstates, tmetric, tstates = _both_states(family, 9, zlib.crc32(family.encode()))
    got = tq.fold_states(tmetric, tstates)
    assert_trees_match(got, jq.fold_states(jmetric, jstates), family)
    assert got["_update_count"].dtype == torch.int32
    oracle = functools.reduce(tmetric.merge_states, tstates)
    if family in EXACT:
        assert_states_equal(got, oracle, family)
    else:
        assert_trees_match(got, oracle, family)


def test_fold_keeps_int32_for_every_integer_leaf():
    for family in ("ddsketch", "hll", "cms"):
        tmetric, tstates = _port_states(family, 5, 3)
        got = tq.fold_states(tmetric, tstates)
        for name, leaf in got.items():
            if not leaf.is_floating_point():
                assert leaf.dtype == torch.int32, (family, name)
        assert got["_update_count"].dtype == torch.int32


def test_init_rows_are_the_identity_and_the_empty_fold_is_init():
    tmetric, tstates = _port_states("hll", 4, 5)
    padded = [tstates[0], tmetric.init_state(), tstates[1], tmetric.init_state(), tstates[2], tstates[3]]
    assert_states_equal(tq.fold_states(tmetric, padded), tq.fold_states(tmetric, tstates))
    for family in FAMILIES:
        make_jax, make_port, _ = FAMILIES[family]
        assert_trees_match(tq.fold_states(make_port(), []), jq.fold_states(make_jax(), []), family)
        assert_trees_match(tq.merge_folds(make_port(), []), jq.merge_folds(make_jax(), []), family)


def test_a_fold_of_one_state_is_that_state_bit_for_bit():
    """``topk_merge`` re-sorts a ledger it touches; a singleton passes through."""
    jmetric, jstates, tmetric, tstates = _both_states("cms", 1, 9, batches_per=3)
    got = tq.fold_states(tmetric, tstates)
    assert_states_equal(got, tstates[0])
    assert_trees_match(got, jq.fold_states(jmetric, jstates))
    assert got["ledger"].data_ptr() != tstates[0]["ledger"].data_ptr()


def test_mean_reduction_is_one_weighted_sum_like_jax():
    tmetric, jmetric = _AvgState(**CPU), _JaxAvgState()
    tstates, jstates = [], []
    for value, count in ((2.0, 1), (5.0, 3), (1.0, 4), (0.3, 7)):
        s = tmetric.init_state()
        s["avg"], s["_update_count"] = torch.tensor(value), torch.tensor(count, dtype=torch.int32)
        tstates.append(s)
        j = jmetric.init_state()
        j["avg"], j["_update_count"] = jnp.asarray(value, jnp.float32), jnp.asarray(count, jnp.int32)
        jstates.append(j)
    got = tq.fold_states(tmetric, tstates)
    assert_trees_match(got, jq.fold_states(jmetric, jstates))
    assert int(got["_update_count"]) == 15
    dyadic = tq.fold_states(tmetric, tstates[:3])
    assert float(dyadic["avg"]) == float(functools.reduce(tmetric.merge_states, tstates[:3])["avg"]) == 2.625


def test_list_states_are_refused_in_both_packages():
    jmetric, tmetric = jm.CatMetric(), tm.CatMetric(**CPU)
    tstates = _tenant_states(tmetric, [[np.asarray([1.0], np.float32)], [np.asarray([2.0], np.float32)]], torch.from_numpy)
    jstates = _tenant_states(jmetric, [[np.asarray([1.0], np.float32)], [np.asarray([2.0], np.float32)]], jnp.asarray)
    with pytest.raises(tq.RollupUnsupported, match="list state") as got:
        tq.fold_states(tmetric, tstates)
    with pytest.raises(jq.RollupUnsupported) as want:
        jq.fold_states(jmetric, jstates)
    assert str(got.value) == str(want.value)
    slab = {"value": [torch.ones(1)], "_update_count": torch.zeros(1, dtype=torch.int32)}
    with pytest.raises(tq.RollupUnsupported, match="list state"):
        tq.fold_slab(tmetric, slab)


# ------------------------------------------------------------------------ trees and caches


@pytest.mark.parametrize("n,fan_in,hops", [(1, 2, 0), (2, 2, 1), (8, 2, 3), (8, 4, 2), (8, 8, 1), (9, 4, 2), (17, 4, 3)])
def test_merge_tree_hops(n, fan_in, hops):
    tmetric, tstates = _port_states("hll", n, n * 10 + fan_in)
    got, got_hops = tq.merge_tree(tmetric, tstates, fan_in=fan_in)
    assert got_hops == hops
    assert_states_equal(got, functools.reduce(tmetric.merge_states, tstates))


@pytest.mark.parametrize("family,n,fan_in", [("cms", 9, 4), ("ddsketch", 6, 2)])
def test_merge_tree_state_equals_jax(family, n, fan_in):
    jmetric, jstates, tmetric, tstates = _both_states(family, n, n + fan_in, batches_per=1)
    got, got_hops = tq.merge_tree(tmetric, tstates, fan_in=fan_in)
    want, want_hops = jq.merge_tree(jmetric, jstates, fan_in=fan_in)
    assert got_hops == want_hops
    assert_trees_match(got, want)


def test_merge_tree_empty_and_validation():
    m = tsk.CardinalitySketch(p=5, **CPU)
    merged, hops = tq.merge_tree(m, [])
    assert hops == 0
    assert_states_equal(merged, m.init_state())
    with pytest.raises(ValueError, match="fan_in"):
        tq.merge_tree(m, [m.init_state()] * 3, fan_in=1)


@pytest.mark.parametrize("fan_in", [2, 3, 7])
def test_merge_tree_shape_is_unobservable(fan_in):
    for family in ("ddsketch", "hll", "cms"):
        tmetric, tstates = _port_states(family, 13, fan_in)
        merged, _ = tq.merge_tree(tmetric, tstates, fan_in=fan_in)
        assert_states_equal(merged, functools.reduce(tmetric.merge_states, tstates), f"{family} {fan_in}")


@pytest.mark.parametrize(("cached", "probe"), [((1, 5), (1, 5)), ((1, 5), (1, 3)), ((1, 5), (1, 6)), ((1, 5), (2, 0)),
                                               ((2, 5), (1, 9)), ((1, 0), (1, 0)), ((0, -1), (0, -1)), ((0, -1), (0, 7))])
def test_watermark_compare_equals_jax(cached, probe):
    assert tq.watermark_compatible(cached, probe) is jq.watermark_compatible(cached, probe)


def test_watermark_cache_lru():
    def entry(tag):
        return tq.CachedGlobal(state={"x": tag}, watermarks={"p0": (1, tag)}, missing=(),
                               report=tq.QueryReport(op="compute"), tenants=1)

    cache = tq.WatermarkCache(capacity=2)
    cache.put("a", entry(1))
    cache.put("b", entry(2))
    assert cache.get("a") is not None
    cache.put("c", entry(3))
    assert cache.get("b") is None and len(cache) == 2
    cache.put("a", entry(4))
    assert cache.get("a").state["x"] == 4 and len(cache) == 2
    cache.invalidate("a")
    assert cache.get("a") is None and cache.get("c") is not None
    cache.invalidate()
    assert len(cache) == 0
    with pytest.raises(ValueError, match="capacity"):
        tq.WatermarkCache(capacity=0)


def test_reports_unpack_and_judge_like_jax():
    rows = (tq.PartitionReport("p0", node="n", follower=True, watermark=(1, 2), tenants=3),
            tq.PartitionReport("p1", error="NoLeaderError: gone"))
    report = tq.QueryReport(op="quantile", partitions=rows, partitions_missing=("p1",))
    jrows = tuple(jq.PartitionReport(**dataclasses.asdict(r)) for r in rows)
    jreport = jq.QueryReport(op="quantile", partitions=jrows, partitions_missing=("p1",))
    assert (report.degraded, report.follower_served, rows[1].missing) == (jreport.degraded, jreport.follower_served,
                                                                         jrows[1].missing) == (True, True, True)
    value, got = tq.GlobalResult(7, report)
    assert value == 7 and got is report


# ------------------------------------------------------------------------ the engine's rollup


def _feed(engines, stream, to=lambda a: a):
    for key, batch in stream:
        for engine in engines:
            engine.submit(key, to(batch))
    for engine in engines:
        engine.flush()


def _rollup_pair(family, engine_kw, stream, *, window=False, setup=None):
    make_jax, make_port, _ = FAMILIES[family]
    port_kw = dict(engine_kw)
    ref = jeng.StreamingEngine(make_jax(), **{k: v for k, v in engine_kw.items() if k != "tier"},
                               **({"tier": jeng.TierConfig(**engine_kw["tier"])} if "tier" in engine_kw else {}))
    if "tier" in port_kw:
        port_kw["tier"] = TierConfig(**port_kw["tier"])
    engine = StreamingEngine(make_port(), **port_kw)
    try:
        if setup is not None:
            setup(engine, ref)
        else:
            _feed([engine, ref], stream)
        return engine.rollup(window=window), ref.rollup(window=window), engine
    finally:
        engine.close()
        ref.close()


def _sketch_stream(seed, n, keys, family="ddsketch"):
    rng = np.random.default_rng(seed)
    draw = FAMILIES[family][2]
    return [(f"t{int(rng.integers(keys))}", draw(rng)) for _ in range(n)]


@pytest.mark.parametrize("family", ["ddsketch", "cms", "max"])
def test_fused_rollup_equals_jax_and_the_scatter(family):
    stream = _sketch_stream(1, 40, 13, family)
    got, want, engine = _rollup_pair(family, {"capacity": 8, "buckets": (8,)}, stream)
    assert got.tenants == want.tenants == len({k for k, _ in stream}) > 8 and not got.follower and got.watermark == want.watermark == (0, -1)
    assert_trees_match(got.state, want.state, family)
    assert got.state["_update_count"].dtype == torch.int32


def _eager_match(got, want, requests):
    """An eager engine updates a request at a time (its ``_update_count``
    counts requests, the fused engines' rows): every other leaf is compared."""
    assert int(got["_update_count"]) == requests
    assert_trees_match({k: v for k, v in got.items() if k != "_update_count"},
                       {k: v for k, v in want.items() if k != "_update_count"})


def test_eager_rollup_equals_jax():
    """A demoted engine (eager states, as after a failed capture) folds its live
    states; the JAX engine stays fused — the fold is the same."""
    stream = _sketch_stream(2, 30, 7)

    def setup(engine, ref):
        _feed([engine, ref], stream[:15])
        engine._demote_to_eager()
        assert not engine.fused
        _feed([engine, ref], stream[15:])

    got, want, _ = _rollup_pair("ddsketch", {"capacity": 4, "buckets": (8,)}, stream, setup=setup)
    assert got.tenants == want.tenants == len({k for k, _ in stream})
    rows_before = sum(len(b) for _k, b in stream[:15])
    _eager_match(got.state, want.state, rows_before + len(stream) - 15)


@pytest.mark.parametrize("eager", [False, True])
def test_windowed_rollup_equals_jax(eager):
    def setup(engine, ref):
        for t in range(5):
            for e, to in ((engine, torch.from_numpy), (ref, jnp.asarray)):
                e.submit(f"t{t}", to(np.full((4,), float(t + 1), np.float32)))
        engine.flush()
        ref.flush()
        engine.rotate_window()
        ref.rotate_window()
        if eager:
            engine._demote_to_eager()
        for t in range(7):
            for e, to in ((engine, torch.from_numpy), (ref, jnp.asarray)):
                e.submit(f"t{t}", to(np.full((2,), 10.0 * (t + 1), np.float32)))
        engine.flush()
        ref.flush()
        live = engine.rollup(window=False)
        if eager:
            _eager_match(live.state, ref.rollup(window=False).state, 7)
        else:
            assert int(live.state["_update_count"]) == 7 * 2
            assert_trees_match(live.state, ref.rollup(window=False).state)

    got, want, _ = _rollup_pair("ddsketch", {"capacity": 4, "buckets": (8,), "window": 3}, None, window=True,
                                setup=setup)
    assert got.tenants == want.tenants == 7
    if eager:
        _eager_match(got.state, want.state, 5 * 4 + 7)
    else:
        assert int(got.state["_update_count"]) == 5 * 4 + 7 * 2
        assert_trees_match(got.state, want.state)


def test_tiered_rollup_equals_jax_and_counts_silent_registrations(tmp_path):
    tier = {"hot_capacity": 3, "warm_capacity": 2, "idle_demote_s": 0.01, "check_interval_s": 0.0,
            "spill_directory": str(tmp_path / "spill")}
    stream = _sketch_stream(3, 30, 9)

    def setup(engine, ref):
        _feed([engine, ref], stream)
        for _ in range(3):  # idle tenants demote on the next drains: warm, then cold
            time.sleep(0.03)
            _feed([engine, ref], [("t0", np.empty(0, np.float32))])
        assert engine.register_tenants([f"silent{i}" for i in range(20)]) == 20
        ref.register_tenants([f"silent{i}" for i in range(20)])
        stats = engine.tier_stats()
        assert stats["warm"] > 0 and stats["cold"] > 20

    got, want, _ = _rollup_pair("ddsketch", {"capacity": 4, "buckets": (8,), "tier": tier}, None, setup=setup)
    assert got.tenants == want.tenants == len({k for k, _ in stream}) + 20
    assert_trees_match(got.state, want.state)


def test_rollup_guards_and_watermarks_match_jax(tmp_path):
    for pkg_engine, metric, cfg, to in ((StreamingEngine, lambda: tm.SumMetric(**CPU), CheckpointConfig, torch.tensor),
                                        (jeng.StreamingEngine, jm.SumMetric, jeng.CheckpointConfig, jnp.asarray)):
        engine = pkg_engine(metric(), capacity=4)
        try:
            with pytest.raises(Exception, match="requires the engine to be built with `window=`"):
                engine.rollup(window=True)
            ru = engine.rollup()
            assert ru.tenants == 0 and ru.watermark == engine.wal_watermark() == (0, -1)
            assert not tq.watermark_compatible(ru.watermark, ru.watermark)
            assert float(ru.state["sum_value"]) == 0.0 and int(ru.state["_update_count"]) == 0
        finally:
            engine.close()
        with pytest.raises(Exception, match="closed") as closed:
            engine.rollup()
        assert type(closed.value).__name__ == "EngineClosed"
        with pytest.raises(Exception, match="closed"):
            engine.wal_watermark()
        journaled = pkg_engine(metric(), capacity=4,
                               checkpoint=cfg(directory=str(tmp_path / pkg_engine.__module__), interval_s=60.0))
        try:
            before = journaled.wal_watermark()
            journaled.submit("t0", to([1.0]))
            journaled.flush()
            after = journaled.wal_watermark()
            assert after[0] == before[0] and after[1] > before[1] and journaled.rollup().watermark == after
        finally:
            journaled.close()


def test_rollup_under_concurrent_writes_is_the_fold_at_its_watermark(tmp_path):
    """A writer keeps submitting while rollups are taken: each rollup equals the
    fold of exactly the WAL records up to its stamp (replayed into a fresh
    engine), so a cached result never claims more or less than its stamp."""
    ck = CheckpointConfig(directory=str(tmp_path), interval_s=3600.0, durable=False)
    make = lambda: tsk.QuantileSketch(quantiles=(0.5,), **CPU)  # noqa: E731
    engine = StreamingEngine(make(), capacity=8, buckets=(8,), checkpoint=ck)
    done = threading.Event()

    def writer():
        rng = np.random.default_rng(0)
        for burst in range(100):  # bursts of 3 committed in turn, so a rollup's flush returns between them
            futures = [engine.submit(f"t{(3 * burst + j) % 12}", rng.lognormal(0, 1, int(rng.integers(1, 5))).astype(np.float32))
                       for j in range(3)]
            for fut in futures:
                fut.result(timeout=60)
            time.sleep(0.001)
        done.set()

    thread = threading.Thread(target=writer)
    rollups = []
    thread.start()
    try:
        while not done.is_set() and len(rollups) < 40:
            rollups.append(engine.rollup())
            time.sleep(0.005)
        thread.join(timeout=60)
        assert done.is_set()
        engine.flush()
        final = engine.wal_watermark()
    finally:
        engine.close(checkpoint=False)
    records = list(RequestJournal(str(tmp_path)).replay())
    assert records and records[-1][0] == final[1]
    stamps = [ru.watermark[1] for ru in rollups]
    assert stamps == sorted(stamps) and len(set(stamps)) >= 2 and stamps[0] < final[1]
    for ru in rollups[:: max(1, len(rollups) // 6)]:
        fresh = StreamingEngine(make(), capacity=8, buckets=(8,))
        try:
            with fresh._dispatch_lock:
                for seq, payload in records:
                    if seq <= ru.watermark[1]:
                        fresh._apply_wal_payload(payload)
            assert_states_equal(ru.state, fresh.rollup().state, f"seq {ru.watermark[1]}")
        finally:
            fresh.close()


def test_a_write_between_the_stamp_and_the_fold_is_in_both(tmp_path):
    """A write dispatched after ``rollup``'s first watermark read and before its
    fold: the fold holds it, and the stamp (re-read in the fold's lock window)
    covers it, so the rollup is still the fold at its stamp."""
    ck = CheckpointConfig(directory=str(tmp_path), interval_s=3600.0, durable=False)
    make = lambda: tsk.QuantileSketch(quantiles=(0.5,), **CPU)  # noqa: E731
    engine = StreamingEngine(make(), capacity=8, buckets=(8,), checkpoint=ck)
    rng = np.random.default_rng(4)
    try:
        engine.submit("t0", rng.lognormal(0, 1, 4).astype(np.float32)).result(timeout=60)
        first = engine.wal_watermark

        def stamp_then_a_write():
            wm = first()
            engine.submit("t1", rng.lognormal(0, 1, 3).astype(np.float32)).result(timeout=60)
            return wm

        engine.wal_watermark = stamp_then_a_write
        ru = engine.rollup()
        del engine.wal_watermark
        assert ru.tenants == 2 and ru.watermark == engine.wal_watermark() and ru.watermark[1] > 0
    finally:
        engine.close(checkpoint=False)
    fresh = StreamingEngine(make(), capacity=8, buckets=(8,))
    try:
        with fresh._dispatch_lock:
            for seq, payload in RequestJournal(str(tmp_path)).replay():
                assert seq <= ru.watermark[1]
                fresh._apply_wal_payload(payload)
        assert_states_equal(ru.state, fresh.rollup().state)
    finally:
        fresh.close()


# ------------------------------------------------------------------------ the global query


class StandInClient:
    """A partitioned client over one engine a partition (either package's):
    every rollup and probe is served by partition i's engine, as a leader."""

    class _PMap:
        def __init__(self, partitions):
            self.partitions = partitions

        def name_of(self, pid):
            return f"p{int(pid)}"

    def __init__(self, engines):
        self.engines = list(engines)
        self.pmap = self._PMap(len(self.engines))

    def rollup(self, pid, *, prefer="replica", window=False):
        node = f"{self.pmap.name_of(pid)}-leader"
        ru = self.engines[pid].rollup(window=window)
        return dataclasses.replace(ru, partition=self.pmap.name_of(pid), node=node), node, True

    def wal_watermark(self, pid, *, prefer="replica", retries=None):
        return self.engines[pid].wal_watermark(), f"{self.pmap.name_of(pid)}-leader", True


class Fleet:
    """P engines of each package, one a partition, journaled (so the cache has
    stamps), fed the same tenants; the oracle replays each tenant's batches."""

    def __init__(self, tmp_path, family, *, journal=True):
        make_jax, make_port, _ = FAMILIES[family]
        self.family, self.ring, self.batches = family, HashRing(P), {}
        self.port = [StreamingEngine(make_port(), capacity=8, buckets=(8,), checkpoint=CheckpointConfig(
            directory=str(tmp_path / f"port{pid}"), interval_s=3600.0, durable=False) if journal else None)
            for pid in range(P)]
        self.jax = [jeng.StreamingEngine(make_jax(), capacity=8, buckets=(8,), checkpoint=jeng.CheckpointConfig(
            directory=str(tmp_path / f"jax{pid}"), interval_s=3600.0, durable=False) if journal else None)
            for pid in range(P)]

    def feed(self, key, batch):
        pid = self.ring.shard_for(key)
        self.port[pid].submit(key, torch.from_numpy(batch))
        self.jax[pid].submit(key, jnp.asarray(batch))
        self.batches.setdefault((pid, key), []).append(batch)

    def flush(self):
        for engine in self.port + self.jax:
            engine.flush()

    def oracle(self, pids=None, port=True):
        metric = FAMILIES[self.family][1 if port else 0]()
        to = torch.from_numpy if port else jnp.asarray
        states = _tenant_states(metric, [b for (pid, _k), b in sorted(self.batches.items(), key=lambda kv: repr(kv[0]))
                                         if pids is None or pid in pids], to)
        return functools.reduce(metric.merge_states, states) if states else metric.init_state()

    def close(self):
        for engine in self.port + self.jax:
            engine.close()


@pytest.fixture
def fleet(tmp_path):
    made = []

    def make(family="ddsketch", **kw):
        made.append(Fleet(tmp_path / str(len(made)), family, **kw))
        return made[-1]

    yield make
    for f in made:
        f.close()


def _feed_fleet(fl, rng, tenants=24, draw=None):
    for t in range(tenants):
        fl.feed(f"tenant-{t}", rng.lognormal(0.0, 1.0, 16).astype(np.float32) if draw is None else draw(rng))
    fl.flush()


def test_global_quantile_equals_the_oracle_in_both_packages(fleet):
    fl = fleet()
    _feed_fleet(fl, np.random.default_rng(0))
    metric, jmetric = tsk.QuantileSketch(quantiles=(0.5,), **CPU), jsk.QuantileSketch(quantiles=(0.5,))
    value, report = tq.GlobalQuery(StandInClient(fl.port), prefer="leader").quantile(metric, 0.99)
    jvalue, jreport = jq.GlobalQuery(StandInClient(fl.jax), prefer="leader").quantile(jmetric, 0.99)
    assert torch.equal(value, metric.quantile_from(fl.oracle(), 0.99))
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), rtol=1e-6)
    assert report.partitions_missing == () and len(report.partitions) == P and report.tenants == 24
    assert not report.cache_hit and not report.follower_served
    assert report.merge_hops == jreport.merge_hops and report.tenants == jreport.tenants
    assert report.watermarks == jreport.watermarks
    assert [(r.partition, r.tenants) for r in report.partitions] == [(r.partition, r.tenants) for r in jreport.partitions]


@pytest.mark.parametrize("family", ["hll", "cms", "sum"])
def test_cardinality_top_k_and_compute_equal_the_oracle(fleet, family):
    fl = fleet(family)
    _feed_fleet(fl, np.random.default_rng(1), tenants=12, draw=FAMILIES[family][2])
    metric, jmetric = FAMILIES[family][1](), FAMILIES[family][0]()
    gq, jgq = tq.GlobalQuery(StandInClient(fl.port)), jq.GlobalQuery(StandInClient(fl.jax))
    if family == "cms":
        (keys, counts), _ = gq.top_k(metric, 5)
        okeys, ocounts = metric.topk_from(fl.oracle(), 5)
        (jkeys, jcounts), _ = jgq.top_k(jmetric, 5)
        assert torch.equal(keys, okeys) and torch.equal(counts, ocounts)
        assert np.array_equal(keys.numpy(), np.asarray(jkeys)) and np.array_equal(counts.numpy(), np.asarray(jcounts))
    else:
        op = "cardinality" if family == "hll" else "compute"
        value, _ = getattr(gq, op)(metric)
        jvalue, _ = getattr(jgq, op)(jmetric)
        assert torch.equal(value, metric.compute_from(fl.oracle()))
        np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), rtol=1e-6)


def _total(counter, **labels):
    return sum(v for key, v in counter.collect().items() if all(dict(key).get(k) == x for k, x in labels.items()))


def test_cache_hits_until_a_watermark_advances(fleet):
    from metrics_tpu_torch.obs.instrument import QUERY_CACHE_HITS, QUERY_CACHE_MISSES, QUERY_LEADER_READS

    obs.reset()
    obs.enable()
    try:
        fl = fleet()
        _feed_fleet(fl, np.random.default_rng(2))
        metric = tsk.QuantileSketch(quantiles=(0.5,), **CPU)
        gq, jgq = tq.GlobalQuery(StandInClient(fl.port)), jq.GlobalQuery(StandInClient(fl.jax))
        v1, r1 = gq.quantile(metric, 0.9)
        v2, r2 = gq.quantile(metric, 0.9)
        _v3, r3 = gq.compute(metric)
        assert (r1.cache_hit, r2.cache_hit, r3.cache_hit) == (False, True, True) and torch.equal(v1, v2)
        assert _total(QUERY_CACHE_HITS) == 2 and _total(QUERY_CACHE_MISSES) == 1
        # the stand-in serves every read from a leader: P rollups, then P probes a hit
        assert _total(QUERY_LEADER_READS) == 3 * P
        jr = [jgq.quantile(jsk.QuantileSketch(quantiles=(0.5,)), 0.9).report.cache_hit for _ in range(2)]
        assert jr == [False, True]
        fl.feed("tenant-0", np.full((8,), 1000.0, np.float32))
        fl.flush()
        v4, r4 = gq.quantile(metric, 0.9)
        assert not r4.cache_hit and torch.equal(v4, metric.quantile_from(fl.oracle(), 0.9))
        assert not jgq.quantile(jsk.QuantileSketch(quantiles=(0.5,)), 0.9).report.cache_hit
        assert 'metrics_tpu_torch_query_global_total{op="quantile",source="cached"} 1' in obs.REGISTRY.render_prometheus()
    finally:
        obs.disable()
        obs.reset()


def test_unjournaled_partitions_never_hit(fleet):
    fl = fleet(journal=False)
    _feed_fleet(fl, np.random.default_rng(3), tenants=8)
    gq = tq.GlobalQuery(StandInClient(fl.port))
    metric = tsk.QuantileSketch(quantiles=(0.5,), **CPU)
    assert [gq.quantile(metric, 0.5).report.cache_hit for _ in range(2)] == [False, False]


def test_a_missing_partition_is_named_and_its_subset_cached(fleet):
    fl = fleet("sum")
    for t in range(16):
        fl.feed(f"tenant-{t}", np.asarray([float(t + 1)], np.float32))
    fl.flush()
    dead = fl.ring.shard_for("tenant-3")
    fl.port[dead].close()
    fl.jax[dead].close()
    metric = tm.SumMetric(**CPU)
    gq = tq.GlobalQuery(StandInClient(fl.port))
    value, report = gq.compute(metric)
    _jvalue, jreport = jq.GlobalQuery(StandInClient(fl.jax)).compute(jm.SumMetric())
    live = [pid for pid in range(P) if pid != dead]
    assert report.degraded and report.partitions_missing == jreport.partitions_missing == (f"p{dead}",)
    assert torch.equal(value, metric.compute_from(fl.oracle(pids=live)))
    missing = next(p for p in report.partitions if p.missing)
    assert missing.partition == f"p{dead}" and missing.error.startswith("EngineClosed")
    value2, report2 = gq.compute(metric)
    assert report2.cache_hit and report2.partitions_missing == report.partitions_missing and torch.equal(value, value2)
    with pytest.raises(tq.PartialResultError, match=f"p{dead}"):
        tq.GlobalQuery(StandInClient(fl.port), require_full=True).compute(metric)


def test_no_live_partitions_and_guards(fleet):
    fl = fleet("sum")
    for engine in fl.port:
        engine.close()
    with pytest.raises(tq.NoLivePartitionsError, match="could not reach ANY partition"):
        tq.GlobalQuery(StandInClient(fl.port)).compute(tm.SumMetric(**CPU))
    with pytest.raises(MetricsTPUUserError, match="quantile"):
        tq.GlobalQuery(StandInClient(fl.port)).quantile(tm.SumMetric(**CPU), 0.5)
    with pytest.raises(MetricsTPUUserError, match="top_k"):
        tq.GlobalQuery(StandInClient(fl.port)).top_k(tm.SumMetric(**CPU))
    with pytest.raises(ValueError, match="prefer"):
        tq.GlobalQuery(StandInClient(fl.port), prefer="nearest")
    assert isinstance(EngineClosed("x"), MetricsTPUUserError)


def test_the_stand_in_is_faithful_to_the_jax_partitioned_client(fleet):
    """Over the same JAX engines, the stand-in and the JAX package's own
    ``PartitionedClient`` (one leader node, leases held) give ``GlobalQuery``
    the same value and the same report."""
    from metrics_tpu.cluster import FakeCoordStore, ManualClock
    from metrics_tpu.part import PartitionedClient, PartitionMap, partition_name

    fl = fleet()
    pmap = PartitionMap(P, seed=7)
    for t in range(20):
        key = f"tenant-{t}"
        fl.jax[pmap.partition_of(key)].submit(key, jnp.asarray(np.random.default_rng(t).lognormal(0, 1, 8), jnp.float32))
    fl.flush()
    store = FakeCoordStore(clock=ManualClock(0.0))
    for pid in range(P):
        assert store.acquire_lease("a", 3.0, name=partition_name(pid)) is not None
    client = PartitionedClient(store, {"a": dict(enumerate(fl.jax))}, pmap=pmap, retries=2, backoff_s=0.001,
                               backoff_cap_s=0.002, sleep=lambda s: None, rng_seed=11)
    metric = jsk.QuantileSketch(quantiles=(0.5,))
    want, want_report = jq.GlobalQuery(client, prefer="leader").quantile(metric, 0.9)
    got, got_report = jq.GlobalQuery(StandInClient(fl.jax), prefer="leader").quantile(metric, 0.9)
    assert float(got) == float(want)
    assert got_report.watermarks == want_report.watermarks and got_report.tenants == want_report.tenants == 20
    assert [(r.partition, r.tenants, r.watermark) for r in got_report.partitions] == \
        [(r.partition, r.tenants, r.watermark) for r in want_report.partitions]


def _replicated_fleet(pkg, root, keys, rng_seed=7):
    """P journaled leaders shipping to P followers over loopback links, one
    ``PartitionedClient`` over both (the JAX ``--query`` benchmark's (b) fleet),
    fed ``keys`` through the client; returns once every follower covers a
    stable leader seq."""
    import metrics_tpu.cluster as jc
    import metrics_tpu.part as jp
    import metrics_tpu.repl as jrepl
    import metrics_tpu_torch.cluster as tc
    import metrics_tpu_torch.part as tp
    import metrics_tpu_torch.repl as trepl

    cluster, part, repl, eng = (tc, tp, trepl, tm.engine) if pkg == "port" else (jc, jp, jrepl, jeng)
    make = FAMILIES["ddsketch"][1 if pkg == "port" else 0]
    store = cluster.FakeCoordStore(clock=cluster.ManualClock(0.0))
    leaders, followers = {}, {}
    for pid in range(P):
        link = repl.LoopbackLink()
        leaders[pid] = eng.StreamingEngine(make(), capacity=8, buckets=(8,), checkpoint=eng.CheckpointConfig(
            directory=str(root / pkg / f"p{pid}"), interval_s=0.05, durable=False), replication=eng.ReplConfig(
            role="primary", transport=repl.FanoutTransport([link]), ship_interval_s=0.01,
            heartbeat_interval_s=0.05, epoch=1))
        followers[pid] = eng.StreamingEngine(make(), capacity=8, buckets=(8,), replication=eng.ReplConfig(
            role="follower", transport=link, poll_interval_s=0.01))
        assert store.acquire_lease("a", 600.0, name=part.partition_name(pid))
    client = part.PartitionedClient(store, {"a": leaders, "b": followers}, pmap=part.PartitionMap(P), retries=4,
                                    rng_seed=rng_seed, sleep=lambda s: None)
    rng = np.random.default_rng(21)
    for key in keys:
        batch = rng.lognormal(0.0, 1.0, 8).astype(np.float32)
        client.submit(key, torch.from_numpy(batch) if pkg == "port" else jnp.asarray(batch))
    deadline = time.monotonic() + 30
    while True:
        for engine in leaders.values():
            engine.flush()
        seqs = {pid: e._wal_seq for pid, e in leaders.items()}
        if all(f._applier.bootstrapped and f._applier.applied_seq >= seqs[pid] for pid, f in followers.items()):
            time.sleep(0.1)
            if all(leaders[pid]._wal_seq == seqs[pid] for pid in leaders):
                return client, leaders, followers
        assert time.monotonic() < deadline, "the followers never caught up"
        time.sleep(0.02)


def test_a_follower_served_global_query_over_the_partitioned_client_equals_jax(tmp_path):
    """``GlobalQuery`` on ``prefer="replica"`` over each package's
    ``PartitionedClient`` (leaders on 'a', followers on 'b'): the populating
    miss and every hit are served by followers, the hit flow makes no leader
    read, and the value and report equal the JAX package's."""
    from metrics_tpu import obs as jobs
    from metrics_tpu.obs.instrument import QUERY_LEADER_READS as JAX_LEADER_READS
    from metrics_tpu_torch.obs.instrument import QUERY_CACHE_HITS, QUERY_LEADER_READS

    keys = [f"dash-{t}" for t in range(24)]
    made = []
    try:
        for pkg in ("jax", "port"):
            made.append(_replicated_fleet(pkg, tmp_path, keys))
        (jclient, jleaders, _jf), (client, leaders, followers) = made
        metric, jmetric = FAMILIES["ddsketch"][1](), FAMILIES["ddsketch"][0]()
        gq, jgq = tq.GlobalQuery(client), jq.GlobalQuery(jclient)
        value, miss = gq.quantile(metric, 0.99)
        jvalue, jmiss = jgq.quantile(jmetric, 0.99)
        obs.reset()
        jobs.reset()
        obs.enable()
        jobs.enable()
        try:
            hits = [gq.quantile(metric, 0.99) for _ in range(5)]
            jhits = [jgq.quantile(jmetric, 0.99) for _ in range(5)]
            assert _total(QUERY_LEADER_READS) == 0 and _total(JAX_LEADER_READS) == 0
            assert _total(QUERY_CACHE_HITS) == 5
        finally:
            obs.disable()
            jobs.disable()
            obs.reset()
            jobs.reset()
        assert all(r.cache_hit and r.follower_served for _v, r in hits) and all(r.cache_hit for _v, r in jhits)
        assert all(torch.equal(v, value) for v, _r in hits)
        oracle = functools.reduce(metric.merge_states, [leaders[client.partition_of(k)]._keyed.state_of(k)
                                                         for k in keys])
        assert torch.equal(value, metric.quantile_from(oracle, 0.99))
        np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), rtol=1e-6)
        assert miss.follower_served and not miss.cache_hit and miss.partitions_missing == ()

        def view(report):
            return (report.watermarks, report.merge_hops, report.tenants, report.partitions_missing,
                    [(r.partition, r.node, r.follower, r.watermark, r.tenants, r.staleness_seqs)
                     for r in report.partitions])

        assert view(miss) == view(jmiss) and view(hits[-1].report) == view(jhits[-1].report)
        assert {r.node for r in miss.partitions} == {"b"} and miss.tenants == len(keys)
    finally:
        for _client, lead, follow in made:
            for engine in [*lead.values(), *follow.values()]:
                engine.close()


# ------------------------------------------------------------------------ the property oracle


@pytest.mark.parametrize("family", ["ddsketch", "hll", "cms", "sum"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_global_merge_equals_centralized_oracle(family, seed):
    rng = np.random.default_rng(zlib.crc32(family.encode()) + seed)
    partitions = int(rng.integers(2, 7))
    tenants = int(rng.integers(partitions, 3 * partitions))
    homes = rng.integers(0, partitions, tenants)
    jmetric, jstates, tmetric, tstates = _both_states(family, tenants, int(rng.integers(1 << 30)))
    live = sorted(rng.choice(partitions, size=int(rng.integers(1, partitions + 1)), replace=False))
    fan_in = int(rng.integers(2, 5))

    def plane(metric, states, fold, tree):
        rollups = [fold(metric, group) for pid in live
                   if (group := [s for s, home in zip(states, homes) if home == pid])]
        return tree(metric, rollups, fan_in=fan_in)[0]

    got = plane(tmetric, tstates, tq.fold_states, tq.merge_tree)
    live_states = [s for s, home in zip(tstates, homes) if home in live]
    oracle = functools.reduce(tmetric.merge_states, live_states) if live_states else tmetric.init_state()
    assert_states_equal(got, oracle, f"{family} seed={seed} live={live} fan_in={fan_in}")
    assert_trees_match(got, plane(jmetric, jstates, jq.fold_states, jq.merge_tree), family)
