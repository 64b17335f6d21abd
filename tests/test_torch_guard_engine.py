"""The guard plane wired through the port's StreamingEngine
(``metrics_tpu_torch/engine/runtime.py`` with ``guard=GuardConfig(...)``) against
the JAX package's engine, on the CPU.

Each parity case feeds the same numpy-seeded requests to a JAX engine and to a
port engine (``device="cpu"``), each with the same ``GuardConfig`` around its
own package's ``ManualClock``, advanced at the same points of the script. The
same submits must be refused with the same error types (quota, quarantine,
deadline, shed, engine quarantine), the committed states must be equal
(``assert_trees_match``: integer states bit for bit with their dtype, float
states within rtol 1e-6), the fair drain must commit requests in the same order,
and ``health()`` must have the same keys and the same breaker states.

Then the takeovers on the port alone, each against a sequential fold: a
dispatcher wedged between drain and processing (the watchdog applies the batch
inline and restarts it), a dispatcher killed by an exception (applied inline,
restarted), and a dispatch lock held as if by a device call (the engine
quarantines and fails every pending future fast, without a hang).

Every engine is closed in a ``finally`` and every wait has a timeout.
"""

import time

import numpy as np
import pytest

import metrics_tpu.guard.faults as jfaults
import metrics_tpu_torch.classification as tcls
import metrics_tpu_torch.guard.faults as tfaults
from metrics_tpu.engine import GuardConfig as JaxGuardConfig
from metrics_tpu.engine import StreamingEngine as JaxEngine
from metrics_tpu_torch.engine import CheckpointConfig, EngineQuarantined, GuardConfig, StreamingEngine
from tests.test_torch_engine import (  # noqa: F401  (_one_torch_thread: the autouse fixture)
    FAMILIES,
    WAIT_S,
    _one_torch_thread,
    assert_engines_match,
    assert_trees_match,
    engine_states,
    fold_rows,
    submit_in_one_drain,
)

CPU = {"device": "cpu"}


def _pair(family="binary_accuracy", guard_kw=None, **engine_kw):
    """A JAX engine and a port engine with the same guard configuration, each
    on its own package's ManualClock; ``(jax engine, port engine, jax clock,
    port clock)``."""
    guard_kw = dict(guard_kw or {})
    make_jax, make_port, _ = FAMILIES[family]
    engine_kw.setdefault("buckets", (8,))
    engine_kw.setdefault("capacity", 4)
    jclock, tclock = jfaults.ManualClock(), tfaults.ManualClock()
    ref = JaxEngine(make_jax(), guard=JaxGuardConfig(clock=jclock, **guard_kw), **engine_kw)
    port = StreamingEngine(make_port(), guard=GuardConfig(clock=tclock, **guard_kw), **engine_kw)
    return ref, port, jclock, tclock


def _outcome(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — the type is the outcome
        return type(exc).__name__
    return "ok"


def _settled(futures):
    """Each future's outcome once resolved: its rows, or its exception's type."""
    out = []
    for f in futures:
        exc = f.exception(timeout=WAIT_S)
        out.append(type(exc).__name__ if exc is not None else f.result()["rows"])
    return out


def _close(*engines):
    for engine in engines:
        engine._worker_gate.set()
        engine.close()


def _hold_until_drained(engine, key, args):
    """Gate the dispatcher and hand it one request: it drains that one and waits
    at the gate, so what is submitted next stays queued until the gate opens."""
    engine._worker_gate.clear()
    first = engine.submit(key, *args)
    deadline = time.monotonic() + WAIT_S
    while engine._active_batch is None and time.monotonic() < deadline:
        time.sleep(0.005)
    assert engine._active_batch is not None
    return first


# --------------------------------------------------------------------------- admission


def test_admission_refuses_the_same_submits_as_jax():
    """Quotas per tenant, refused takes that consume nothing, refills on the
    clock, and deadlines already expired at submit."""
    rng = np.random.default_rng(3)
    script = []
    for i in range(60):
        if i % 9 == 8:
            script.append(("advance", 0.35))
        else:
            rows = int(rng.integers(1, 5))
            deadline = 0.0 if i % 13 == 5 else None
            script.append((f"t{int(rng.integers(0, 3))}", (rng.integers(0, 2, rows), rng.integers(0, 2, rows)),
                           deadline))
    guard_kw = dict(quota_rows_per_s=10.0, quota_burst_rows=12.0, tenant_quotas={"t2": 0.0}, shed=False)
    ref, port, jclock, tclock = _pair(guard_kw=guard_kw)
    try:
        outcomes = []
        for engine, clock in ((ref, jclock), (port, tclock)):
            seen = []
            for step in script:
                if step[0] == "advance":
                    clock.advance(step[1])
                    continue
                key, args, deadline = step
                seen.append(_outcome(lambda: engine.submit(key, *args, deadline=deadline)))
            engine.flush(timeout=WAIT_S)
            outcomes.append(seen)
        assert outcomes[1] == outcomes[0]
        assert {"ok", "QuotaExceeded", "DeadlineExceeded"} <= set(outcomes[1])
        p, r = port.telemetry_snapshot(), ref.telemetry_snapshot()
        for name in ("submitted", "processed", "quota_rejections", "deadline_expired", "failed"):
            assert p[name] == r[name], name
        assert_engines_match(port, ref)
    finally:
        _close(ref, port)


def test_deadlines_expire_in_queue_as_in_jax():
    """Requests queued behind a held dispatcher whose deadlines lapse fail fast
    with DeadlineExceeded, never reach the state, and the others commit."""
    rng = np.random.default_rng(4)
    reqs = [(f"t{i % 3}", (rng.integers(0, 2, 2), rng.integers(0, 2, 2)), [None, 5.0, 50.0][i % 3])
            for i in range(18)]
    ref, port, jclock, tclock = _pair(guard_kw=dict(shed=False), max_queue=64)
    try:
        results = []
        for engine, clock in ((ref, jclock), (port, tclock)):
            first = _hold_until_drained(engine, "warm", (np.array([1]), np.array([1])))
            futures = [engine.submit(key, *args, deadline=d) for key, args, d in reqs]
            clock.advance(10.0)  # the 5 s deadlines lapse while queued
            engine._worker_gate.set()
            engine.flush(timeout=WAIT_S)
            results.append(_settled([first] + futures))
        assert results[1] == results[0]
        assert results[1].count("DeadlineExceeded") == 6
        assert port.telemetry_snapshot()["deadline_expired"] == ref.telemetry_snapshot()["deadline_expired"] == 6
        assert_engines_match(port, ref)
    finally:
        _close(ref, port)


def test_standing_overload_sheds_the_same_requests_as_jax():
    """CoDel in standing overload sheds the oldest low-priority request; higher
    priorities are never shed."""
    guard_kw = dict(shed_target_s=0.05, shed_interval_s=0.1, shed_max_priority=0)
    ref, port, jclock, tclock = _pair(guard_kw=guard_kw, max_queue=256)
    try:
        results = []
        for engine, clock in ((ref, jclock), (port, tclock)):
            first = _hold_until_drained(engine, "warm", (np.array([1]), np.array([1])))
            low = [engine.submit("t", np.array([1]), np.array([1])) for _ in range(4)]
            high = [engine.submit("t", np.array([0]), np.array([1]), priority=1) for _ in range(4)]
            clock.advance(1.0)
            engine._guard.shedder.on_drain(1.0)  # arm: one overloaded drain already seen
            clock.advance(0.2)
            engine._worker_gate.set()
            engine.flush(timeout=WAIT_S)
            results.append(_settled([first] + low + high))
        assert results[1] == results[0]
        assert results[1].count("RequestShed") == 1 and "RequestShed" not in results[1][5:]
        assert port.telemetry_snapshot()["shed"] == ref.telemetry_snapshot()["shed"] == 1
        assert_engines_match(port, ref)
    finally:
        _close(ref, port)


def test_poison_tenant_is_quarantined_and_probed_as_in_jax():
    """Two failing requests quarantine the tenant (threshold 2): its submits are
    refused until the probation lapses, one probe is admitted, a good probe
    forgives; the other tenants are served throughout."""
    guard_kw = dict(shed=False, quarantine_threshold=2, quarantine_probation_s=1.0)
    ref, port, jclock, tclock = _pair(guard_kw=guard_kw)
    good = (np.array([1, 0]), np.array([1, 1]))
    try:
        traces = []
        for engine, clock, faults in ((ref, jclock, jfaults), (port, tclock, tfaults)):
            trace = []
            for _ in range(2):
                f = engine.submit("bad", *faults.poison_args())
                trace.append(_settled([f])[0])
                engine.flush(timeout=WAIT_S)
            trace.append(_outcome(lambda: engine.submit("bad", *good)))
            trace.append(_settled([engine.submit("ok", *good)])[0])
            trace.append(sorted(engine.health()["quarantined_tenants"]))
            clock.advance(1.5)
            probe = engine.submit("bad", *good)
            trace.append(_outcome(lambda: engine.submit("bad", *good)))  # one probe at a time
            trace.append(_settled([probe])[0])
            engine.flush(timeout=WAIT_S)
            trace.append(_settled([engine.submit("bad", *good)])[0])
            engine.flush(timeout=WAIT_S)
            trace.append(sorted(engine.health()["quarantined_tenants"]))
            traces.append(trace)
        assert traces[1] == traces[0]
        assert traces[1][2] == "TenantQuarantined" and traces[1][4] == ["bad"] and traces[1][-1] == []
        for name in ("quarantines", "quarantine_rejections", "failed", "processed"):
            assert port.telemetry_snapshot()[name] == ref.telemetry_snapshot()[name], name
        assert_engines_match(port, ref)
    finally:
        _close(ref, port)


# --------------------------------------------------------------------------- the fair drain


@pytest.mark.parametrize("quantum,weights", [(16, {}), (8, {"heavy": 0.25}), (None, {})])
def test_fair_drain_commits_in_the_jax_order(quantum, weights):
    """A 10x heavy tenant beside three light ones, taken in one drain: both
    engines commit the requests in the same order (weighted deficit round-robin
    across drains, each tenant's own order kept) and end with equal states."""
    rng = np.random.default_rng(6)
    stream = []
    for i in range(80):
        key = "heavy" if i % 11 else f"light-{i % 3}"
        rows = int(rng.integers(1, 5))
        stream.append((key, (rng.integers(0, 2, rows), rng.integers(0, 2, rows))))
    ref, port, _, _ = _pair(guard_kw=dict(shed=False, drain_quantum_rows=quantum, tenant_weights=weights),
                            buckets=(4, 16), max_queue=256)
    try:
        orders = []
        for engine in (ref, port):
            order = []
            futures = submit_in_one_drain(engine, stream)
            for i, f in enumerate(futures):
                f.add_done_callback(lambda _f, i=i: order.append(i))
            engine.flush(timeout=WAIT_S)
            assert all(f.result(timeout=WAIT_S) for f in futures)
            orders.append(order)
        assert orders[1] == orders[0]
        for key in {k for k, _ in stream}:
            mine = [i for i in orders[1] if stream[i][0] == key]
            assert mine == sorted(mine), key
        p, r = port.telemetry_snapshot(), ref.telemetry_snapshot()
        assert (p["batches"], p["rows"]) == (r["batches"], r["rows"])
        assert_engines_match(port, ref)
        for key, fold in fold_rows(FAMILIES["binary_accuracy"][1](), stream).items():
            assert_trees_match(port._keyed.state_of(key), fold, key)
    finally:
        _close(ref, port)


def test_concurrent_clients_through_a_small_drain_quantum_lose_no_row():
    """Four client threads, a drain quantum of 8 rows (most requests wait in
    the fair backlog across drains) and a 10 µs switch interval: every tenant
    ends with its fold."""
    import sys
    import threading

    engine = StreamingEngine(FAMILIES["binary_accuracy"][1](), buckets=(4, 8), capacity=4, max_queue=64,
                             guard=GuardConfig(shed=False, drain_quantum_rows=8))
    rng = np.random.default_rng(19)
    stream = [(f"t{int(rng.integers(0, 6))}", (rng.integers(0, 2, r), rng.integers(0, 2, r)))
              for r in rng.integers(1, 6, 300)]
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
        assert snap["failed"] == 0 and snap["processed"] == len(stream)
        for key, fold in fold_rows(FAMILIES["binary_accuracy"][1](), stream).items():
            assert_trees_match(engine._keyed.state_of(key), fold, key)
    finally:
        sys.setswitchinterval(interval)
        engine.close()


# --------------------------------------------------------------------------- the capture governor


def test_capture_governor_routes_novel_signatures_eagerly_as_jax_does():
    """A capture budget of one: the first novel (signature, bucket) is captured,
    the next ones run eagerly on the engine's device (receipt bucket None,
    ``compile_rejections``), cached graphs keep serving; states as in JAX."""
    rng = np.random.default_rng(8)
    guard_kw = dict(shed=False, compile_rate_per_s=0.0, compile_burst=1.0, breaker_failure_threshold=1,
                    breaker_probation_s=1000.0)
    ref, port, _, _ = _pair(guard_kw=guard_kw, buckets=(2, 4, 8, 16))
    try:
        reqs = [(rng.integers(0, 2, rows), rng.integers(0, 2, rows)) for rows in (1, 1, 3, 7, 1, 12, 3, 1)]
        receipts = []
        for engine in (ref, port):
            got = []
            for args in reqs:
                f = engine.submit("t", *args)
                got.append(f.result(timeout=WAIT_S)["bucket"])
                engine.flush(timeout=WAIT_S)
            receipts.append(got)
        assert receipts[1] == receipts[0] == [2, 2, None, None, 2, None, None, 2]
        p, r = port.telemetry_snapshot(), ref.telemetry_snapshot()
        assert p["compile_rejections"] == r["compile_rejections"] == 4
        assert p["compiles"] == r["compiles"] == 1
        assert port.health()["breakers"]["compile"]["state"] == ref.health()["breakers"]["compile"]["state"]
        assert_engines_match(port, ref)
    finally:
        _close(ref, port)


# --------------------------------------------------------------------------- health


def test_health_keys_and_breakers_match_jax(tmp_path):
    ref, port, _, _ = _pair()
    try:
        for engine in (ref, port):
            engine.submit("t", np.array([1]), np.array([1])).result(timeout=WAIT_S)
        h_port, h_ref = port.health(), ref.health()
        assert list(h_port) == list(h_ref)
        assert sorted(h_port["breakers"]) == sorted(h_ref["breakers"]) == ["ckpt", "comm", "compile"]
        for name in h_ref["breakers"]:
            assert h_port["breakers"][name] == h_ref["breakers"][name], name
        for key in ("state", "worker_alive", "worker_restarts", "queue_depth", "shedding", "quarantined_tenants"):
            assert h_port[key] == h_ref[key], key
        assert h_port["state"] == "SERVING"
    finally:
        _close(ref, port)


def test_health_transition_hook_fires_once_per_edge():
    edges = []
    engine = StreamingEngine(tcls.BinaryAccuracy(**CPU), buckets=(8,),
                             guard=GuardConfig(shed=False, on_health_transition=lambda a, b: edges.append((a, b)),
                                               watchdog_timeout_s=0.2, watchdog_poll_s=0.02,
                                               hang_lock_timeout_s=0.2))
    try:
        with tfaults.wedge_dispatcher(engine), tfaults.hold_dispatch_lock(engine):
            f = engine.submit("k", np.array([1]), np.array([1]))
            assert isinstance(f.exception(timeout=WAIT_S), EngineQuarantined)
        engine.health()
        engine.health()
        assert edges == [("SERVING", "QUARANTINED")]
    finally:
        engine.close()


def test_checkpoint_breaker_suspends_snapshots_after_failures(tmp_path):
    """Snapshot commits that keep failing trip the ckpt breaker: attempts are
    suspended (``ckpt_suspended``) while serving and the WAL go on."""
    cfg = CheckpointConfig(directory=str(tmp_path), interval_s=0.0, durable=False)
    engine = StreamingEngine(tcls.BinaryAccuracy(**CPU), buckets=(8,), checkpoint=cfg,
                             guard=GuardConfig(shed=False, breaker_failure_threshold=2, breaker_probation_s=1000.0))
    try:
        def failing_commit(*a, **k):
            raise OSError("disk full")

        engine._ckpt_store.commit = failing_commit
        for _ in range(12):
            engine.submit("k", np.array([1]), np.array([1])).result(timeout=WAIT_S)
            assert engine._ckpt_writer.quiesce(timeout=WAIT_S)
        snap, health = engine.telemetry_snapshot(), engine.health()
        assert snap["checkpoint_failures"] >= 2
        assert snap["ckpt_suspended"] >= 1
        assert health["breakers"]["ckpt"]["state"] == "open" and health["state"] == "DEGRADED"
        assert snap["processed"] == 12 and not health["wal_disabled"]
    finally:
        engine.close(checkpoint=False)


# --------------------------------------------------------------------------- takeovers against a fold


def _watched(**guard_kw):
    # the timeout outlasts any honest micro-batch of the flagship collection on a
    # loaded CPU: a slower one would be declared hung while it holds the lock
    guard_kw.setdefault("shed", False)
    guard_kw.setdefault("watchdog_timeout_s", 1.0)
    guard_kw.setdefault("watchdog_poll_s", 0.02)
    guard_kw.setdefault("hang_lock_timeout_s", 1.0)
    return StreamingEngine(FAMILIES["flagship"][1](), buckets=(8,), capacity=4, guard=GuardConfig(**guard_kw))


def _wait_for(cond, what):
    deadline = time.monotonic() + WAIT_S
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert cond(), what


def _fold(stream, whole):
    """Per-tenant sequential fold of ``stream`` on the CPU: request ``i`` in one
    ``update_state`` where ``whole(i)`` (how the inline path applies it), else a
    row at a time (how a micro-batch applies it), so ``_update_count`` counts as
    the engine did."""
    import torch

    metric = FAMILIES["flagship"][1]()
    states = {}
    for i, (key, args) in enumerate(stream):
        state = states.get(key, metric.init_state())
        parts = [args] if whole(i) else [tuple(a[r : r + 1] for a in args) for r in range(args[0].shape[0])]
        for part in parts:
            state = metric.update_state(state, *(torch.from_numpy(np.ascontiguousarray(a)) for a in part))
        states[key] = state
    return states


def _flagship_stream(seed, n):
    rng = np.random.default_rng(seed)
    gen = FAMILIES["flagship"][2]
    return [(f"t{int(rng.integers(0, 3))}", gen(rng, int(rng.integers(1, 5)))) for _ in range(n)]


def test_a_wedged_dispatcher_is_taken_over_and_restarted():
    """Wedged between drain and processing: the watchdog applies the batch and
    the queue inline, a fresh dispatcher serves the fused path again, and every
    tenant's state equals the sequential fold."""
    stream = _flagship_stream(11, 24)
    engine = _watched()
    try:
        with tfaults.wedge_dispatcher(engine):
            futures = [engine.submit(key, *args) for key, args in stream[:16]]
            engine.flush(timeout=WAIT_S)
            assert all(f.result(timeout=WAIT_S)["bucket"] is None for f in futures)
            _wait_for(lambda: not engine.degraded, "no restart after the takeover")
        futures = [engine.submit(key, *args) for key, args in stream[16:]]
        engine.flush(timeout=WAIT_S)
        assert all(f.result(timeout=WAIT_S)["bucket"] == 8 for f in futures)
        snap = engine.telemetry_snapshot()
        assert (snap["worker_hangs"], snap["watchdog_restarts"], snap["failed"]) == (1, 1, 0)
        assert engine.health()["state"] == "SERVING" and engine.health()["worker_restarts"] == 1
        folds = _fold(stream, lambda i: i < 16)
        assert set(engine_states(engine)) == set(folds)
        for key, fold in folds.items():
            assert_trees_match(engine._keyed.state_of(key), fold, key)
    finally:
        engine.close()


def test_a_killed_dispatcher_is_replaced():
    stream = _flagship_stream(12, 12)
    engine = _watched(watchdog_timeout_s=None)
    try:
        boom = tfaults.kill_dispatcher(engine)
        futures = submit_in_one_drain(engine, stream)  # the batch the crash hits holds them all
        engine.flush(timeout=WAIT_S)
        assert all(f.result(timeout=WAIT_S)["rows"] >= 1 for f in futures)
        _wait_for(lambda: engine.telemetry_snapshot()["watchdog_restarts"] == 1, "no restart after the death")
        assert engine._worker_error is boom and not engine.degraded
        assert engine.submit(*stream[0][:1], *stream[0][1]).result(timeout=WAIT_S)["bucket"] == 8
        folds = _fold(stream + [stream[0]], lambda i: i < len(stream))
        for key, fold in folds.items():
            assert_trees_match(engine._keyed.state_of(key), fold, key)
    finally:
        engine.close()


def test_a_held_dispatch_lock_quarantines_without_a_hang():
    """The worker holds the dispatch lock as if inside a device call: no
    request is applied twice — the engine quarantines, every pending future
    fails with EngineQuarantined, calls fail fast, close() returns."""
    stream = _flagship_stream(13, 6)
    engine = _watched()
    try:
        done = [engine.submit(key, *args) for key, args in stream[:3]]
        engine.flush(timeout=WAIT_S)
        before = engine_states(engine)
        t0 = time.monotonic()
        with tfaults.wedge_dispatcher(engine), tfaults.hold_dispatch_lock(engine):
            futures = [engine.submit(key, *args) for key, args in stream[3:]]
            _wait_for(lambda: engine.quarantined, "the engine did not quarantine")
            for f in futures:
                assert isinstance(f.exception(timeout=WAIT_S), EngineQuarantined)
            engine.flush(timeout=5)
        assert time.monotonic() - t0 < WAIT_S
        assert engine.health()["state"] == "QUARANTINED"
        for call in (lambda: engine.submit("t0", *stream[0][1]), lambda: engine.compute("t0"),
                     lambda: engine.evict_tenant("t0"), lambda: engine.rotate_window()):
            with pytest.raises(EngineQuarantined):
                call()
        assert [f.result()["rows"] for f in done] == [args[0].shape[0] for _, args in stream[:3]]
        snap = engine.telemetry_snapshot()
        assert (snap["worker_hangs"], snap["watchdog_restarts"], snap["failed"]) == (1, 0, 3)
        for key, state in before.items():
            assert_trees_match(engine._keyed.state_of(key), state, key)
    finally:
        t0 = time.monotonic()
        engine.close()
        assert time.monotonic() - t0 < WAIT_S


def test_a_superseded_worker_never_applies_its_batch():
    """The takeover owns the batch: when the wedged worker's gate reopens it
    finds its epoch stale and retires, so no row is applied twice."""
    engine = _watched()
    try:
        old = engine._worker
        with tfaults.wedge_dispatcher(engine):
            f = engine.submit("t0", np.array([1], np.int32), np.array([1], np.int32))
            engine.flush(timeout=WAIT_S)
            assert f.result(timeout=WAIT_S)["bucket"] is None
            _wait_for(lambda: engine._worker is not old, "no fresh dispatcher")
        old.join(WAIT_S)
        assert not old.is_alive()
        state = engine._keyed.state_of("t0")
        assert int(state["accuracy"]["_update_count"]) == 1
    finally:
        engine.close()


def test_guarded_engine_serves_on_the_cpu_only_when_asked():
    """Entry points default to the card: without a GPU a guarded engine built
    without ``device=`` raises instead of serving on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device serves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingEngine(tcls.BinaryAccuracy(), guard=GuardConfig())
