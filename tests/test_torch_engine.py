"""The port's StreamingEngine (``metrics_tpu_torch/engine/runtime.py``) against the
JAX package's, on the CPU.

Every parity test feeds the same numpy-seeded requests to ``metrics_tpu.engine``
(the CPU, ``tests/conftest.py`` settings) and to ``metrics_tpu_torch.engine``
(``device="cpu"``), then compares every tenant's state leaf by leaf: integer
states bit for bit with their dtype (int32 counts stay int32), float states
within rtol 1e-6 (float32 sums that the two frameworks may add in other orders,
as ``tests/test_torch_aggregation.py`` allows). The families served are the JAX
engine tests' ``BinaryAccuracy``, ``BinaryF1Score`` and ``MeanSquaredError``,
and ``MulticlassAccuracy``, the flagship collection at C = 10, the three
sketches, ``MeanMetric`` and the binned ``BinaryAUROC``.

On the CPU the port's micro-batch kernel is the masked scan as a plain loop
(there is nothing to capture), so a metric that the JAX engine cannot trace
still fuses there: ``test_host_read_metric_fuses_on_the_cpu`` says so.
``chip_smoke.py`` Phase K holds the demotion on the card, where a host read
inside a capture fails.

Every engine is closed in a ``finally``, and every wait has a timeout, so a hang
fails one test instead of the suite's time limit.
"""

import threading
import time
from concurrent.futures import wait

import jax
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.classification as jcls
import metrics_tpu.sketch as jsk
import metrics_tpu_torch as tm
import metrics_tpu_torch.classification as tcls
import metrics_tpu_torch.sketch as tsk
from metrics_tpu.engine import StreamingEngine as JaxEngine
from metrics_tpu_torch.engine import EngineBackpressure, EngineClosed, StreamingEngine
from metrics_tpu_torch.engine.runtime import _GraphKernel, _LoopKernel
from metrics_tpu_torch.metric import Metric, zero_state

C = 10
WAIT_S = 60  # the longest any future or flush is waited for


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one thread per test beside the suite's parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------- metrics and data


def _labels(rng, rows):
    return rng.integers(0, C, rows).astype(np.int32), rng.integers(0, C, rows).astype(np.int32)


def _scores(rng, rows):
    return rng.random(rows).astype(np.float32), rng.integers(0, 2, rows).astype(np.int32)


def _flagship(pkg, **kw):
    return pkg.MetricCollection({
        "accuracy": pkg.classification.MulticlassAccuracy(C, average="micro", **kw),
        "f1": pkg.classification.MulticlassF1Score(C, average="macro", **kw),
        "confmat": pkg.classification.MulticlassConfusionMatrix(C, **kw),
    })


CPU = {"device": "cpu"}
# name -> (JAX metric, port metric, request generator)
FAMILIES = {
    "accuracy": (lambda: jcls.MulticlassAccuracy(C, average="micro"),
                 lambda: tcls.MulticlassAccuracy(C, average="micro", **CPU), _labels),
    "flagship": (lambda: _flagship(jm), lambda: _flagship(tm, **CPU), _labels),
    "quantile": (lambda: jsk.QuantileSketch(), lambda: tsk.QuantileSketch(**CPU),
                 lambda rng, r: (rng.lognormal(0, 1, r).astype(np.float32),)),
    "cardinality": (lambda: jsk.CardinalitySketch(p=6), lambda: tsk.CardinalitySketch(p=6, **CPU),
                    lambda rng, r: (rng.integers(0, 800, r).astype(np.int32),)),
    "heavy_hitters": (lambda: jsk.HeavyHittersSketch(k=8, depth=3, width=64),
                      lambda: tsk.HeavyHittersSketch(k=8, depth=3, width=64, **CPU),
                      lambda rng, r: (np.minimum(rng.zipf(1.3, r), 40).astype(np.int32),)),
    "mean": (lambda: jm.MeanMetric(), lambda: tm.MeanMetric(**CPU),
             lambda rng, r: (rng.random(r).astype(np.float32),)),
    "auroc": (lambda: jcls.BinaryAUROC(thresholds=20), lambda: tcls.BinaryAUROC(thresholds=20, **CPU), _scores),
    "binary_accuracy": (lambda: jcls.BinaryAccuracy(), lambda: tcls.BinaryAccuracy(**CPU),
                        lambda rng, r: (rng.integers(0, 2, r), rng.integers(0, 2, r))),
    "binary_f1": (lambda: jcls.BinaryF1Score(), lambda: tcls.BinaryF1Score(**CPU), _scores),
    "mse": (lambda: jm.MeanSquaredError(), lambda: tm.MeanSquaredError(**CPU),
            lambda rng, r: (rng.normal(size=r).astype(np.float32), rng.normal(size=r).astype(np.float32))),
}


def _stream(gen, seed, n, keys, max_rows=6):
    rng = np.random.default_rng(seed)
    return [(f"t{int(rng.integers(0, keys))}", gen(rng, int(rng.integers(1, max_rows + 1)))) for _ in range(n)]


# --------------------------------------------------------------------------- comparisons


def _flat(tree, prefix=""):
    """``{path: numpy array}`` of a state tree of either package."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix.rstrip("/"): tree.detach().cpu().numpy()}
    return {prefix.rstrip("/"): np.asarray(jax.device_get(tree))}


def assert_trees_match(got, want, what=""):
    """Integer leaves bit-identical with their dtype, float leaves within rtol 1e-6."""
    a, b = _flat(got), _flat(want)
    assert set(a) == set(b), (what, sorted(a), sorted(b))
    for path in a:
        x, y = a[path], b[path]
        assert x.dtype == y.dtype and x.shape == y.shape, (what, path, x.dtype, y.dtype, x.shape, y.shape)
        if np.issubdtype(x.dtype, np.floating):
            np.testing.assert_allclose(x, y, rtol=1e-6, err_msg=f"{what} {path}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {path}")


def engine_states(engine):
    """Every tenant's live state, as the engine keeps it."""
    return {key: engine._keyed.state_of(key) for key in engine._keyed.keys}


def assert_engines_match(port, ref):
    p, r = engine_states(port), engine_states(ref)
    assert set(p) == set(r)
    for key in r:
        assert_trees_match(p[key], r[key], str(key))


def fold_rows(metric, stream):
    """Per-tenant sequential fold, ONE ROW at a time in submission order: the
    engine's dispatch semantics (``_update_count`` counts rows)."""
    states = {}
    for key, args in stream:
        state = states.get(key, metric.init_state())
        for i in range(args[0].shape[0]):
            state = metric.update_state(state, *(torch.from_numpy(np.ascontiguousarray(a[i : i + 1])) for a in args))
        states[key] = state
    return states


def run_stream(engine, stream):
    """Submit in order from this thread, flush, and check every receipt."""
    futures = [engine.submit(key, *args) for key, args in stream]
    engine.flush(timeout=WAIT_S)
    done, not_done = wait(futures, timeout=WAIT_S)
    assert not not_done
    return [f.result() for f in futures]


def run_both(family, stream, **engine_kw):
    """The same stream through both engines; ``(port snapshot, JAX snapshot,
    port states, JAX states, port computes, JAX computes)``."""
    make_jax, make_port, _ = FAMILIES[family]
    ref = JaxEngine(make_jax(), **engine_kw)
    port = StreamingEngine(make_port(), **engine_kw)
    try:
        run_stream(ref, stream)
        run_stream(port, stream)
        out = (port.telemetry_snapshot(), ref.telemetry_snapshot(), engine_states(port), engine_states(ref),
               port.compute_all(), ref.compute_all())
    finally:
        port.close()
        ref.close()
    return out


# --------------------------------------------------------------------------- parity


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fused_states_match_jax(family):
    """Single-threaded submits of 1-6 rows over 3 tenants: every tenant's state and
    value equal the JAX engine's, on the fused path of both."""
    stream = _stream(FAMILIES[family][2], seed=1, n=30, keys=3)
    p_snap, r_snap, p_states, r_states, p_vals, r_vals = run_both(family, stream, buckets=(8,), capacity=4)
    assert p_snap["fused"] and r_snap["fused"]
    assert p_snap["fused_fallbacks"] == r_snap["fused_fallbacks"] == 0
    assert p_snap["processed"] == r_snap["processed"] == len(stream)
    assert (p_snap["rows"], p_snap["batches"]) == (r_snap["rows"], r_snap["batches"])
    assert set(p_states) == set(r_states)
    for key in r_states:
        assert_trees_match(p_states[key], r_states[key], key)
        assert_trees_match(p_vals[key], r_vals[key], key)


def test_concurrent_multi_client_matches_sequential_and_jax():
    """Four client threads, random keys and batch sizes: every tenant's state is
    bit-identical to a sequential per-tenant fold and to the JAX engine fed the
    same requests (integer counts: the interleaving cannot matter)."""
    make_jax, make_port, gen = FAMILIES["accuracy"]
    stream = _stream(gen, seed=7, n=120, keys=6, max_rows=5)
    engine = StreamingEngine(make_port(), buckets=(8, 32), capacity=4)
    ref = JaxEngine(make_jax(), buckets=(8, 32), capacity=4)
    try:
        futures, lock = [], threading.Lock()

        def client(tid):
            for i, (key, args) in enumerate(stream):
                if i % 4 == tid:
                    f = engine.submit(key, *args)
                    with lock:
                        futures.append(f)

        threads = [threading.Thread(target=client, args=(tid,)) for tid in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(WAIT_S)
            assert not th.is_alive()
        engine.flush(timeout=WAIT_S)
        done, not_done = wait(futures, timeout=WAIT_S)
        assert not not_done and all(f.exception() is None for f in done)
        run_stream(ref, stream)

        folds = fold_rows(make_port(), stream)
        for key, fold in folds.items():
            assert_trees_match(engine._keyed.state_of(key), fold, key)
        assert_engines_match(engine, ref)
        snap = engine.telemetry_snapshot()
        assert snap["processed"] == len(stream)
        assert snap["fused"] and not snap["degraded"]
    finally:
        engine.close()
        ref.close()


def test_collection_single_dispatch_update():
    """A MetricCollection engine updates every member in the same micro-batch, and
    the tenant's values equal a sequentially updated collection's."""
    engine = StreamingEngine(_flagship(tm, **CPU), buckets=(16,))
    try:
        oracle = _flagship(tm, **CPU)
        rng = np.random.default_rng(3)
        for _ in range(12):
            p, t = _labels(rng, 4)
            engine.submit("tenant", p, t)
            oracle.update(torch.from_numpy(p), torch.from_numpy(t))
        got, exp = engine.compute("tenant"), oracle.compute()
        assert got.keys() == exp.keys()
        for k in exp:
            assert torch.equal(got[k], exp[k]), k
    finally:
        engine.close()


def test_int64_and_int32_clients_share_one_graph_key():
    """A numpy-int64 client and an int32 client have one signature (the JAX
    package's canonical dtypes), so one kernel serves both; the counts are the
    JAX engine's."""
    rng = np.random.default_rng(2)
    stream = []
    for i in range(10):
        p, t = _labels(rng, 3)
        cast = np.int64 if i % 2 else np.int32
        stream.append(("k", (p.astype(cast), t.astype(cast))))
    p_snap, r_snap, p_states, r_states, _, _ = run_both("accuracy", stream, buckets=(4,), capacity=2)
    assert p_snap["compiles"] == r_snap["compiles"] == 1
    assert_trees_match(p_states["k"], r_states["k"])


def test_oversized_request_chunks_exactly():
    rng = np.random.default_rng(5)
    stream = [("big", _labels(rng, 19))]
    p_snap, r_snap, p_states, r_states, _, _ = run_both("accuracy", stream, buckets=(4,))
    assert p_snap["batches"] == r_snap["batches"] == 5
    assert_trees_match(p_states["big"], r_states["big"])


def test_mixed_signature_tenant_keeps_its_order():
    """One tenant alternates two shape signatures in one drained batch: the port
    groups consecutive runs, as the JAX engine does, so the order-dependent
    heavy-hitter ledger equals the JAX engine's."""
    rng = np.random.default_rng(9)
    stream = []
    for i in range(12):
        ids = np.minimum(rng.zipf(1.3, 4), 40).astype(np.int32)
        stream.append(("k", (ids if i % 2 else ids.reshape(2, 2),)))
    make_jax, make_port, _ = FAMILIES["heavy_hitters"]
    ref = JaxEngine(make_jax(), buckets=(8,), capacity=2)
    port = StreamingEngine(make_port(), buckets=(8,), capacity=2)
    try:
        for engine in (ref, port):
            engine._worker_gate.clear()  # one drained batch holds the whole stream
            futures = [engine.submit(key, *args) for key, args in stream]
            engine._worker_gate.set()
            engine.flush(timeout=WAIT_S)
            assert all(f.result(timeout=WAIT_S) for f in futures)
        assert_engines_match(port, ref)
    finally:
        for engine in (ref, port):
            engine._worker_gate.set()
            engine.close()


def test_signature_groups_preserve_tenant_order():
    class R:  # minimal _Request stand-in for the grouping helper
        def __init__(self, key, sig):
            self.key, self.signature = key, sig

    a, b = ("sigA",), ("sigB",)
    groups = StreamingEngine._signature_groups([R("x", a), R("y", b), R("x", a)])
    assert [(s, len(rs)) for s, rs in groups] == [(a, 2), (b, 1)]
    groups = StreamingEngine._signature_groups([R("x", a), R("x", b), R("y", a)])
    assert [(s, [r.key for r in rs]) for s, rs in groups] == [(a, ["x"]), (b, ["x"]), (a, ["y"])]


def test_eager_fallback_for_list_state_metric():
    """Ragged 'cat' states cannot stack along a key axis: both engines serve the
    exact-mode AUROC eagerly, with equal values."""
    jax_make = lambda: jcls.BinaryAUROC(thresholds=None)  # noqa: E731
    port_make = lambda: tcls.BinaryAUROC(thresholds=None, **CPU)  # noqa: E731
    assert port_make()._host_compute and jax_make()._host_compute
    rng = np.random.default_rng(11)
    stream = [("x", _scores(rng, 5)) for _ in range(6)]
    ref, engine = JaxEngine(jax_make()), StreamingEngine(port_make())
    try:
        assert not engine.fused and not ref.fused
        run_stream(ref, stream)
        run_stream(engine, stream)
        np.testing.assert_allclose(engine.compute("x").numpy(), np.asarray(ref.compute("x")), rtol=1e-6)
    finally:
        engine.close()
        ref.close()


class _PortBranchy(Metric):
    """Reads a value on the host inside its update (no capture can hold that)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("hits", zero_state((), torch.int32, self.device), "sum")
        self.add_state("rows", zero_state((), torch.int32, self.device), "sum")

    def update(self, x):
        if int(x.sum()) >= 0:
            self.hits = self.hits + (x > 0).sum(dtype=torch.int32)
        self.rows = self.rows + x.shape[0]

    def compute(self):
        return self.hits


class _JaxBranchy(jm.Metric):
    def __init__(self):
        super().__init__()
        import jax.numpy as jnp

        self.add_state("hits", jnp.zeros((), jnp.int32), "sum")
        self.add_state("rows", jnp.zeros((), jnp.int32), "sum")

    def update(self, x):
        import jax.numpy as jnp

        if int(jnp.sum(x)) >= 0:  # a concretization error inside jit
            self.hits = self.hits + jnp.sum(x > 0, dtype=jnp.int32)
        self.rows = self.rows + x.shape[0]

    def compute(self):
        return self.hits


def test_host_read_metric_fuses_on_the_cpu():
    """A metric that reads a value on the host demotes the JAX engine (it cannot
    be traced). On the CPU the port's fused path is the masked scan as a plain
    loop, with nothing captured, so the port stays fused there; on the card the
    capture fails and the engine demotes (``chip_smoke.py`` Phase K5). The counts
    agree; ``_update_count`` does not, in the JAX package either: the fused path
    updates per row, the eager path per request."""
    rng = np.random.default_rng(4)
    stream = [(f"k{i % 2}", (rng.integers(-1, 3, 3).astype(np.int32),)) for i in range(8)]
    ref, engine = JaxEngine(_JaxBranchy(), buckets=(8,)), StreamingEngine(_PortBranchy(**CPU), buckets=(8,))
    try:
        run_stream(ref, stream)
        run_stream(engine, stream)
        assert ref.telemetry_snapshot()["fused_fallbacks"] == 1 and not ref.fused
        assert engine.telemetry_snapshot()["fused_fallbacks"] == 0 and engine.fused
        for key in ("k0", "k1"):
            got, want = engine._keyed.state_of(key), ref._keyed.state_of(key)
            assert_trees_match({k: got[k] for k in ("hits", "rows")}, {k: want[k] for k in ("hits", "rows")}, key)
            assert int(got["_update_count"]) == int(got["rows"]) == 12  # one update per row, 4 requests of 3
    finally:
        engine.close()
        ref.close()


def test_uncapturable_update_demotes_with_state_preserved(monkeypatch):
    """The ladder's second step: a kernel failure that the eager retry does not
    reproduce demotes the engine once, keeps every row committed before it, and
    counts ``fused_fallbacks``. (On the card a capture that fails takes this path;
    here the loop kernel is made to fail as such a capture does.)"""
    engine = StreamingEngine(tcls.MulticlassAccuracy(C, average="micro", **CPU), buckets=(8,))
    oracle = tcls.MulticlassAccuracy(C, average="micro", **CPU)
    rng = np.random.default_rng(6)
    try:
        p, t = _labels(rng, 3)
        engine.submit("k", p, t).result(timeout=WAIT_S)
        oracle.update(torch.from_numpy(p), torch.from_numpy(t))

        def failing(self, keyed, key_ids, mask, columns):
            from metrics_tpu_torch.engine.runtime import _FusedUnsupported

            raise _FusedUnsupported("operation not permitted when stream is capturing")

        monkeypatch.setattr(_LoopKernel, "__call__", failing)
        futures = []
        for _ in range(3):
            p, t = _labels(rng, 2)
            futures.append(engine.submit("k", p, t))
            oracle.update(torch.from_numpy(p), torch.from_numpy(t))
        engine.flush(timeout=WAIT_S)
        assert all(f.result(timeout=WAIT_S)["bucket"] is None for f in futures)
        snap = engine.telemetry_snapshot()
        assert not engine.fused and snap["fused_fallbacks"] == 1 and not snap["degraded"]
        assert torch.equal(engine.compute("k"), oracle.compute())
    finally:
        engine.close()


def test_malformed_request_rejected_without_demoting_engine():
    """One tenant submitting shape-incompatible arrays fails ONLY that request, in
    both engines: each stays fused and its dispatcher alive."""
    rng = np.random.default_rng(8)
    good = _labels(rng, 2)
    bad = (np.zeros((2, 3), np.int32), np.zeros((2, 4), np.int32))
    make_jax, make_port, _ = FAMILIES["accuracy"]
    for engine in (JaxEngine(make_jax(), buckets=(8,)), StreamingEngine(make_port(), buckets=(8,))):
        try:
            assert engine.submit("ok", *good).result(timeout=WAIT_S)["rows"] == 2
            assert engine.submit("bad", *bad).exception(timeout=WAIT_S) is not None
            engine.flush(timeout=WAIT_S)
            assert engine.fused and not engine.degraded
            assert engine.submit("ok", *good).result(timeout=WAIT_S)["bucket"] == 8
            assert engine.telemetry_snapshot()["failed"] == 1
        finally:
            engine.close()


# --------------------------------------------------------------------------- ladder and lifecycle


def test_compile_count_bounded_by_buckets_after_warmup():
    """After one pass over every bucket, further traffic (and a reset, which writes
    the slab in place) adds no kernel: the cache is exactly the bucket ladder, as
    the JAX engine's."""
    buckets = (4, 8, 16)
    rng = np.random.default_rng(0)
    traffic = [(("a", "b", "c", "d")[int(rng.integers(0, 4))], _labels(rng, int(rng.integers(1, 17))))
               for _ in range(30)]
    make_jax, make_port, _ = FAMILIES["accuracy"]
    for engine in (JaxEngine(make_jax(), buckets=buckets, capacity=4),
                   StreamingEngine(make_port(), buckets=buckets, capacity=4)):
        try:
            for key in ("a", "b", "c", "d"):
                engine._alloc_slot(key)
            for rows in (3, 7, 15):
                engine.submit("a", *_labels(rng, rows))
                engine.flush(timeout=WAIT_S)
            warm = engine.telemetry_snapshot()["compiles"]
            assert warm == len(buckets)
            engine.reset()
            run_stream(engine, traffic)
            assert engine.telemetry_snapshot()["compiles"] == warm
        finally:
            engine.close()


def test_capacity_growth_drops_the_old_kernels():
    """A growth makes new slab tensors; the kernels keyed by the old capacity can
    never run again and are dropped (the JAX engine keeps its compiled ones)."""
    engine = StreamingEngine(FAMILIES["accuracy"][1](), buckets=(8,), capacity=1)
    try:
        rng = np.random.default_rng(1)
        engine.submit("a", *_labels(rng, 2)).result(timeout=WAIT_S)
        assert [k[2] for k in engine._kernels] == [1]
        engine.submit("b", *_labels(rng, 2)).result(timeout=WAIT_S)
        assert [k[2] for k in engine._kernels] == [2]
        assert all(isinstance(k, _LoopKernel) for k in engine._kernels.values())
        assert engine.graph_stats() == [] and engine.graph_launches() == {}
    finally:
        engine.close()


def test_backpressure_block_policy():
    engine = StreamingEngine(FAMILIES["accuracy"][1](), max_queue=2, policy="block", buckets=(8,))
    p, t = np.array([1], np.int32), np.array([1], np.int32)
    try:
        engine._worker_gate.clear()  # hold the dispatcher before it processes
        engine.submit("k", p, t)  # drained into the held dispatcher
        time.sleep(0.2)
        engine.submit("k", p, t)
        engine.submit("k", p, t)  # queue now full (2)
        blocked_done = threading.Event()

        def blocked_submit():
            engine.submit("k", p, t)
            blocked_done.set()

        th = threading.Thread(target=blocked_submit)
        th.start()
        time.sleep(0.3)
        assert not blocked_done.is_set()  # block policy: waiting, not raising
        engine._worker_gate.set()
        assert blocked_done.wait(WAIT_S)
        th.join(WAIT_S)
        assert not th.is_alive()
        engine.flush(timeout=WAIT_S)
        assert float(engine.compute("k")) == 1.0
        assert engine.telemetry_snapshot()["processed"] == 4
    finally:
        engine._worker_gate.set()
        engine.close()


def test_backpressure_drop_policy():
    engine = StreamingEngine(FAMILIES["accuracy"][1](), max_queue=2, policy="drop", buckets=(8,))
    p, t = np.array([1], np.int32), np.array([1], np.int32)
    try:
        engine._worker_gate.clear()
        engine.submit("k", p, t)
        time.sleep(0.2)
        engine.submit("k", p, t)
        engine.submit("k", p, t)
        with pytest.raises(EngineBackpressure, match="dropped"):
            engine.submit("k", p, t)
        assert engine.telemetry_snapshot()["dropped"] == 1
        engine._worker_gate.set()
        engine.flush(timeout=WAIT_S)
        assert engine.telemetry_snapshot()["processed"] == 3
    finally:
        engine._worker_gate.set()
        engine.close()


def test_backpressure_timeout_policy():
    engine = StreamingEngine(FAMILIES["accuracy"][1](), max_queue=1, policy="timeout", submit_timeout=0.2,
                             buckets=(8,))
    p, t = np.array([1], np.int32), np.array([1], np.int32)
    try:
        engine._worker_gate.clear()
        engine.submit("k", p, t)
        time.sleep(0.2)
        engine.submit("k", p, t)
        t0 = time.monotonic()
        with pytest.raises(EngineBackpressure, match="timed out"):
            engine.submit("k", p, t)
        assert time.monotonic() - t0 >= 0.15
        assert engine.telemetry_snapshot()["timed_out"] == 1
    finally:
        engine._worker_gate.set()
        engine.close()


def test_worker_death_degrades_to_inline_dispatch():
    """A dead dispatcher loses no request: accepted work completes inline and later
    submits run synchronously on the caller's thread (counted)."""
    engine = StreamingEngine(FAMILIES["accuracy"][1](), buckets=(8,))
    p, t = np.array([1, 0], np.int32), np.array([1, 1], np.int32)
    try:
        engine.submit("k", p, t)
        engine.flush(timeout=WAIT_S)
        boom = RuntimeError("injected dispatcher crash")

        def exploding_process(batch, *args):
            raise boom

        engine._process = exploding_process
        f = engine.submit("k", p, t)
        assert f.result(timeout=WAIT_S)["key"] == "k"
        deadline = time.monotonic() + WAIT_S
        while not engine.degraded and time.monotonic() < deadline:
            time.sleep(0.01)
        assert engine.degraded and engine._worker_error is boom
        f2 = engine.submit("k", p, t)
        assert f2.done() and f2.result()["bucket"] is None
        oracle = FAMILIES["accuracy"][1]()
        for _ in range(3):
            oracle.update(torch.from_numpy(p), torch.from_numpy(t))
        assert torch.equal(engine.compute("k"), oracle.compute())
        snap = engine.telemetry_snapshot()
        assert snap["worker_deaths"] == 1 and snap["inline_dispatches"] >= 2
        assert engine.health()["state"] == "DEGRADED"
    finally:
        engine.close()


def test_flush_blocks_through_worker_death_replay():
    engine = StreamingEngine(FAMILIES["accuracy"][1](), buckets=(8,))
    one = np.array([1], np.int32)
    try:
        engine._worker_gate.clear()
        futures = [engine.submit("k", one, one) for _ in range(6)]
        engine._process = lambda batch, *a: (_ for _ in ()).throw(RuntimeError("boom"))
        engine._worker_gate.set()
        engine.flush(timeout=WAIT_S)
        assert all(f.done() and f.exception() is None for f in futures)
        assert engine.degraded
        assert float(engine.compute("k")) == 1.0
    finally:
        engine._worker_gate.set()
        engine.close()


def test_close_semantics():
    engine = StreamingEngine(FAMILIES["accuracy"][1](), buckets=(8,))
    one = np.array([1], np.int32)
    f = engine.submit("k", one, one)
    engine.close()  # default: drains accepted work first
    assert f.result(timeout=WAIT_S)["rows"] == 1
    with pytest.raises(EngineClosed):
        engine.submit("k", one, one)
    engine.close()  # idempotent
    assert engine.health()["closed"] and not engine.health()["worker_alive"]


def test_context_manager_and_receipt():
    with StreamingEngine(FAMILIES["mean"][1](), buckets=(8,)) as engine:
        receipt = engine.submit(("tuple", "key"), np.array([1.0, 2.0], np.float32)).result(timeout=WAIT_S)
        assert receipt == {"key": ("tuple", "key"), "rows": 2, "bucket": 8}
        assert float(engine.compute(("tuple", "key"))) == pytest.approx(1.5)
        with pytest.raises(KeyError):
            engine.compute("never-seen")


def test_compute_all_consistent_snapshot():
    engine = StreamingEngine(FAMILIES["accuracy"][1](), buckets=(8,))
    try:
        engine.submit("a", np.array([1, 1], np.int32), np.array([1, 0], np.int32))
        engine.submit("b", np.array([1], np.int32), np.array([1], np.int32))
        out = engine.compute_all()
        assert set(out) == {"a", "b"}
        assert float(out["a"]) == 0.5 and float(out["b"]) == 1.0
        with pytest.raises(Exception, match="window"):
            engine.compute_all(window=True)
    finally:
        engine.close()


def test_drain_tenant_waits_for_its_requests_only():
    engine = StreamingEngine(FAMILIES["accuracy"][1](), buckets=(8,))
    one = np.array([1], np.int32)
    try:
        engine._worker_gate.clear()
        engine.submit("a", one, one)
        with pytest.raises(TimeoutError):
            engine.drain_tenant("a", timeout=0.2)
        engine.drain_tenant("b", timeout=WAIT_S)  # nothing pending for b
        engine._worker_gate.set()
        engine.drain_tenant("a", timeout=WAIT_S)
        assert float(engine.compute("a")) == 1.0
    finally:
        engine._worker_gate.set()
        engine.close()


# --------------------------------------------------------------------------- value checks under the trace (C.4)

# name -> (JAX metric, port metric, requests that only a value check rejects)
_UNCHECKED = {
    "confmat_label_above_C": (lambda: jcls.MulticlassConfusionMatrix(3),
                              lambda: tcls.MulticlassConfusionMatrix(3, **CPU),
                              [(np.array([0, 1], np.int32), np.array([0, 3], np.int32))]),
    "accuracy_label_above_C": (lambda: jcls.MulticlassAccuracy(3, average="micro"),
                               lambda: tcls.MulticlassAccuracy(3, average="micro", **CPU),
                               [(np.array([0, 1], np.int32), np.array([0, 3], np.int32))]),
    "mean_nan_warn": (lambda: jm.MeanMetric(), lambda: tm.MeanMetric(**CPU),
                      [(np.array([1.0, np.nan], np.float32),), (np.array([2.0], np.float32),)]),
    "mean_nan_error": (lambda: jm.MeanMetric(nan_strategy="error"), lambda: tm.MeanMetric(nan_strategy="error", **CPU),
                       [(np.array([1.0, np.nan], np.float32),), (np.array([2.0], np.float32),)]),
}


@pytest.mark.parametrize("case", sorted(_UNCHECKED))
def test_micro_batch_skips_value_checks_as_the_jax_trace_does(case):
    """The JAX engine traces its micro-batch, so no value check runs there: a label
    above ``num_classes`` is dropped from the counts and a NaN enters the mean.
    The port's loop kernel runs ``traced()`` and does the same, with no failed
    receipt; states and values equal the JAX engine's (NaN where JAX has NaN)."""
    make_jax, make_port, reqs = _UNCHECKED[case]
    stream = [("k", args) for args in reqs]
    ref, port = JaxEngine(make_jax(), buckets=(4,)), StreamingEngine(make_port(), buckets=(4,))
    try:
        run_stream(ref, stream)
        run_stream(port, stream)
        for engine in (ref, port):
            snap = engine.telemetry_snapshot()
            assert engine.fused and snap["failed"] == 0 and snap["fused_fallbacks"] == 0
        assert_engines_match(port, ref)
        got, want = port.compute("k"), ref.compute("k")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    finally:
        port.close()
        ref.close()


def test_jitted_update_state_skips_value_checks_as_jax_jit_does():
    """``jitted_update_state`` is ``jax.jit`` in the JAX package: a label above
    ``num_classes`` is dropped, not refused. The port's updater on CPU tensors
    runs ``traced()`` and returns the same table; eager ``update`` and
    ``update_state`` keep the check and raise the JAX type."""
    preds, target = np.array([0, 1], np.int32), np.array([0, 3], np.int32)
    jmetric, tmetric = jcls.MulticlassConfusionMatrix(3), tcls.MulticlassConfusionMatrix(3, **CPU)
    want = jmetric.jitted_update_state()(jmetric.init_state(), preds, target)
    got = tmetric.jitted_update_state()(tmetric.init_state(), torch.from_numpy(preds), torch.from_numpy(target))
    assert_trees_match(got, want)
    assert got["confmat"].tolist() == [[1, 0, 0], [0, 0, 0], [0, 0, 0]]
    for update in (jmetric.update, lambda p, t: jmetric.update_state(jmetric.init_state(), p, t)):
        with pytest.raises(RuntimeError, match="more unique values"):
            update(preds, target)
    for update in (tmetric.update, lambda p, t: tmetric.update_state(tmetric.init_state(), p, t)):
        with pytest.raises(RuntimeError, match="more unique values"):
            update(torch.from_numpy(preds), torch.from_numpy(target))


def test_traced_flag_is_per_thread_and_nests():
    from metrics_tpu_torch.utils.checks import _value_check_possible, traced

    x = torch.zeros(2)
    seen = []
    with traced():
        with traced():
            assert not _value_check_possible(x)
        assert not _value_check_possible(x)
        other = threading.Thread(target=lambda: seen.append(_value_check_possible(x)))
        other.start()
        other.join(WAIT_S)
    assert not other.is_alive() and seen == [True]
    assert _value_check_possible(x)


# --------------------------------------------------------------------------- tenant eviction (C.5)


def test_evict_tenant_on_an_untiered_engine_matches_jax():
    """``evict_tenant`` works without the tier plane, as the JAX package's
    docstring says: True for a known key, False for an unknown one, the key gone
    from ``compute_all``, its slot reused by the next new tenant, and a
    resubmitted key starting from a fresh state; states equal the JAX engine's
    throughout and ``tier_evictions`` counts the eviction."""
    rng = np.random.default_rng(12)
    first = _stream(_labels, seed=13, n=12, keys=3)
    later = [(key, _labels(rng, 3)) for key in ("t3", "t0", "t3", "t0")]
    make_jax, make_port, _ = FAMILIES["flagship"]
    ref, port = JaxEngine(make_jax(), buckets=(8,), capacity=4), StreamingEngine(make_port(), buckets=(8,), capacity=4)
    try:
        for engine in (ref, port):
            run_stream(engine, first)
            slot = engine._keyed._slots["t0"]
            assert engine.evict_tenant("t0") is True
            assert engine.evict_tenant("t0") is False and engine.evict_tenant("nobody") is False
            assert "t0" not in engine.compute_all()
            assert engine.telemetry_snapshot()["tier_evictions"] == 1
            run_stream(engine, later)
            assert engine._keyed._slots["t3"] == slot  # the freed slot goes to the next new tenant
        assert_engines_match(port, ref)
        for key, fold in fold_rows(make_port(), later).items():
            assert_trees_match(port._keyed.state_of(key), fold, f"{key} after the eviction")
    finally:
        port.close()
        ref.close()


# --------------------------------------------------------------------------- what waits, devices, hooks


@pytest.mark.parametrize("plane,item", [("guard", "A.7"), ("replication", "A.7"), ("tier", "A.7")])
def test_planes_not_ported_raise_naming_their_item(plane, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        StreamingEngine(FAMILIES["accuracy"][1](), **{plane: object()})
    engine = StreamingEngine(FAMILIES["accuracy"][1](), buckets=(8,), start=False)
    with pytest.raises(NotImplementedError, match="ROADMAP A.7"):
        engine.export_tenant("k")
    with pytest.raises(NotImplementedError, match="ROADMAP A.7"):
        engine.import_tenant("k", None)


@pytest.mark.parametrize("plane", ["guard", "replication", "tier"])
def test_checkpoint_is_accepted_and_the_other_planes_still_raise(plane, tmp_path):
    """``checkpoint=`` (the durable state plane) is ported: the engine takes it
    beside no other plane, serves and journals; with it, each other plane still
    raises naming A.7."""
    from metrics_tpu_torch.engine import CheckpointConfig

    cfg = CheckpointConfig(directory=str(tmp_path), interval_s=3600.0, durable=False)
    with pytest.raises(NotImplementedError, match="ROADMAP A.7"):
        StreamingEngine(FAMILIES["accuracy"][1](), checkpoint=cfg, **{plane: object()})
    engine = StreamingEngine(FAMILIES["accuracy"][1](), buckets=(8,), checkpoint=cfg)
    try:
        run_stream(engine, [("k", (np.array([1], np.int32), np.array([1], np.int32)))])
        assert engine.telemetry_snapshot()["wal_records"] == 1
        assert engine.health()["state"] == "SERVING" and not engine.health()["wal_disabled"]
    finally:
        engine.close()


def test_reads_that_wait_raise_naming_their_item():
    engine = StreamingEngine(FAMILIES["accuracy"][1](), buckets=(8,))
    try:
        engine.submit("k", np.array([1], np.int32), np.array([1], np.int32))
        with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
            engine.compute("k", sync=True)
        with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
            engine.compute_all(sync=True)
        with pytest.raises(NotImplementedError, match="ROADMAP A.9"):
            engine.rollup()
        assert engine.telemetry_snapshot()["read_jit_fallbacks"] == 0
    finally:
        engine.close()


def test_engine_serves_on_the_metric_device_and_cuda_needs_a_gpu():
    """``device=None`` serves where the metric lives; the default device of a
    metric, and an explicit ``device="cuda"``, need a GPU and raise without one."""
    engine = StreamingEngine(FAMILIES["accuracy"][1](), buckets=(8,), start=False)
    assert engine.device == torch.device("cpu")
    assert engine._stream is None and isinstance(engine._build_kernel(), _LoopKernel)
    if torch.cuda.is_available():
        gpu = StreamingEngine(FAMILIES["accuracy"][1](), buckets=(8,), device="cuda", start=False)
        assert gpu.device.type == "cuda" and isinstance(gpu._build_kernel(), _GraphKernel)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            StreamingEngine(FAMILIES["accuracy"][1](), device="cuda")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcls.MulticlassAccuracy(C)


def test_rejects_what_is_not_a_metric_and_bad_arguments():
    from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

    with pytest.raises(MetricsTPUUserError, match="Metric or MetricCollection"):
        StreamingEngine(object())
    with pytest.raises(MetricsTPUUserError, match="policy"):
        StreamingEngine(FAMILIES["accuracy"][1](), policy="shed")
    with pytest.raises(MetricsTPUUserError, match="max_queue"):
        StreamingEngine(FAMILIES["accuracy"][1](), max_queue=0)


@pytest.mark.parametrize("family", ["accuracy", "flagship"])
def test_jitted_update_state_on_the_cpu_is_update_state(family):
    """The engine hook: for CPU tensors the updater is the plain ``update_state``
    (a CUDA graph per shape on the card), cached per instance and not carried
    into a clone."""
    metric = FAMILIES[family][1]()
    updater = metric.jitted_update_state()
    assert metric.jitted_update_state() is updater
    assert metric.jitted_update_state(donate=False) is not updater
    rng = np.random.default_rng(3)
    state, ref = metric.init_state(), metric.init_state()
    for _ in range(3):
        p, t = (torch.from_numpy(a) for a in _labels(rng, 5))
        state, ref = updater(state, p, t), metric.update_state(ref, p, t)
    assert_trees_match(state, ref)
    assert "_jitted_update_state" not in metric.clone().__dict__


def test_docstring_example_runs():
    import doctest

    import metrics_tpu_torch.engine.runtime as runtime

    result = doctest.testmod(runtime, verbose=False)
    assert result.attempted > 0 and result.failed == 0
