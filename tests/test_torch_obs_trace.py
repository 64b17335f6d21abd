"""The port's trace contexts, tracer, flight recorder and fleet telemetry
(``metrics_tpu_torch/obs/{context,trace,flight,fleet}.py``) against the JAX
package's, on the CPU.

- The 17-byte wire block is the JAX package's byte for byte, and so are the R
  and C records' trace trailers.
- A WAL journaled by the port with obs on recovers in the JAX engine, and the
  reverse, with the ``engine.replay`` span naming the submitting trace id in
  both packages (the twin of ``tests/obs/test_trace_propagation.py``); a port
  follower's replay names its primary's trace ids.
- Flight bundles the port's guard dumps load in both packages' ``load_bundle``,
  and a JAX bundle in the port's; each trigger fires once per edge, as in
  ``tests/obs/test_flight.py``.
- A node snapshot of either package merges in both packages' aggregators.

Both packages' obs switches are process-global: every test resets both.
"""

import json
import time

import numpy as np
import pytest
import torch

import metrics_tpu.classification as jcls
from metrics_tpu import obs as jobs
from metrics_tpu.engine import CheckpointConfig as JaxCheckpointConfig
from metrics_tpu.engine import GuardConfig as JaxGuardConfig
from metrics_tpu.engine import StreamingEngine as JaxEngine
from metrics_tpu.engine import runtime as jruntime
from metrics_tpu.guard.faults import poison_args as jax_poison_args
from metrics_tpu.obs import context as jctx
from metrics_tpu.obs import fleet as jfleet
from metrics_tpu.obs import flight as jflight
from metrics_tpu_torch import obs
from metrics_tpu_torch.classification import BinaryAccuracy
from metrics_tpu_torch.engine import CheckpointConfig, GuardConfig, ReplConfig, StreamingEngine
from metrics_tpu_torch.engine import runtime as truntime
from metrics_tpu_torch.guard.faults import kill_dispatcher, poison_args
from metrics_tpu_torch.obs import context as tctx
from metrics_tpu_torch.obs.fleet import AGGREGATOR, SNAPSHOT_KIND, FleetAggregator, node_snapshot
from metrics_tpu_torch.obs.flight import BUNDLE_KIND, FLIGHT, TRIGGERS, load_bundle
from metrics_tpu_torch.obs.trace import Tracer
from metrics_tpu_torch.repl import LoopbackLink

from tests.test_torch_engine import assert_trees_match

WAIT_S = 30


@pytest.fixture(autouse=True)
def _obs_isolation():
    obs.reset()
    jobs.reset()
    yield
    obs.reset()
    jobs.reset()
    FLIGHT.configure(directory=None)


def _rows(seed, n, keys=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rows = int(rng.integers(1, 6))
        out.append((f"t{rng.integers(0, keys)}", rng.integers(0, 2, rows).astype(np.int32),
                    rng.integers(0, 2, rows).astype(np.int32)))
    return out


def _replay_trace_ids(spans):
    out = set()
    for s in spans:
        if s["name"] == "engine.replay" and s["attrs"].get("traces"):
            out.update(s["attrs"]["traces"].split(","))
    return out


# --------------------------------------------------------------------------- the wire block


CONTEXTS = [(1, 1, True), (0xFFFFFFFFFFFFFFFF, 0x8000000000000000, False), (0x0123456789ABCDEF, 42, True)]


@pytest.mark.parametrize("trace_id,span_id,sampled", CONTEXTS)
def test_wire_block_is_the_jax_packages_byte_for_byte(trace_id, span_id, sampled):
    port, ref = tctx.TraceContext(trace_id, span_id, sampled), jctx.TraceContext(trace_id, span_id, sampled)
    assert port.to_bytes() == ref.to_bytes() and len(port.to_bytes()) == tctx.WIRE_SIZE == 17
    back = tctx.TraceContext.from_bytes(ref.to_bytes())
    assert (back.trace_id, back.span_id, back.sampled) == (trace_id, span_id, sampled)
    assert (port.trace_hex, port.span_hex) == (ref.trace_hex, ref.span_hex)
    assert tctx.trace_attrs(port) == jctx.trace_attrs(ref)


def test_iter_wire_blocks_reads_a_jax_trailer_and_ignores_a_short_remainder():
    blocks = [jctx.TraceContext(i + 1, i + 2, bool(i % 2)) for i in range(3)]
    payload = b"body" + b"".join(b.to_bytes() for b in blocks) + b"xyz"
    got = list(tctx.iter_wire_blocks(payload, 4))
    assert [(c.trace_id, c.span_id, c.sampled) for c in got] == [(b.trace_id, b.span_id, b.sampled) for b in blocks]
    assert list(tctx.iter_wire_blocks(b"body", 4)) == []


def test_context_propagation_rules():
    assert tctx.current() is None and tctx.mint_or_current() is None  # obs off: nothing minted
    obs.enable()
    minted = tctx.mint_or_current()
    assert minted is not None and minted.trace_id != 0 and minted.span_id != 0
    ctx = tctx.mint()
    with tctx.activate(ctx):
        assert tctx.current() is ctx and tctx.mint_or_current() is ctx  # adopted, not re-minted
        child = ctx.child()
        assert child.trace_id == ctx.trace_id and child.span_id != ctx.span_id
        with tctx.activate(None):
            assert tctx.current() is None
        assert tctx.current() is ctx
    assert tctx.current() is None


def test_request_and_chunk_trailers_are_the_jax_layout():
    ctx = (0x1111, 0x2222, True)
    key = b"\x80\x05\x95\x06\x00\x00\x00\x00\x00\x00\x00\x8c\x02t0\x94."
    args = (np.array([1, 0, 1], np.int32), np.array([1, 1, 0], np.int32))
    port = truntime._encode_request_record(key, args, tctx.TraceContext(*ctx))
    assert port == jruntime._encode_request_record(key, args, jctx.TraceContext(*ctx))
    dkey, dargs, dctx = truntime._decode_request_record(port)
    assert dkey == "t0" and (dctx.trace_id, dctx.span_id) == ctx[:2]
    assert truntime._decode_request_record(truntime._encode_request_record(key, args))[2] is None
    cols = [np.zeros((8, 1), np.int32), np.ones((8, 1), np.int32)]
    kid, mask = np.zeros(8, np.int32), np.arange(8) < 3
    ctxs = [(5, 6, True), (7, 8, False)]
    port = truntime._encode_chunk_record([(0, key)], kid, mask, cols, [tctx.TraceContext(*c) for c in ctxs])
    assert port == jruntime._encode_chunk_record([(0, key)], kid, mask, cols, [jctx.TraceContext(*c) for c in ctxs])
    assert truntime._record_trace_hexes(port) == jruntime._record_trace_hexes(port) == f"{5:016x},{7:016x}"
    assert truntime._record_trace_hexes(b"Z") == ""


# --------------------------------------------------------------------------- the tracer


def test_tracer_spans_nest_export_and_wrap(tmp_path):
    tracer = Tracer(capacity=3)
    with tracer.span("off"):
        pass
    assert tracer.total_recorded == 0  # obs off: the shared no-op
    obs.enable()
    with tracer.span("outer", a=1) as outer:
        with tracer.span("inner"):
            pass
        outer.set_attr(b=2)
    with pytest.raises(ValueError):
        with tracer.span("boom"):
            raise ValueError("x")
    spans = tracer.spans()
    assert [s["name"] for s in spans] == ["inner", "outer", "boom"]
    assert spans[0]["parent"] == "outer" and spans[1]["attrs"] == {"a": 1, "b": 2}
    assert spans[2]["attrs"]["error"] == "ValueError"
    doc = tracer.export_chrome_trace(str(tmp_path / "t.json"))
    assert json.load(open(tmp_path / "t.json"))["traceEvents"] == doc["traceEvents"]
    events = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(events) == 3 and all(e["cat"] == "metrics_tpu_torch" for e in events)
    with tracer.span("fourth"):
        pass
    assert [s["name"] for s in tracer.spans()] == ["outer", "boom", "fourth"] and tracer.total_recorded == 4
    with pytest.raises(ValueError):
        Tracer(capacity=0)


def test_metric_update_opens_a_span():
    obs.enable()
    m = BinaryAccuracy(device="cpu")
    m.update(torch.tensor([1, 0]), torch.tensor([1, 1]))
    assert any(s["name"] == "metric.update" and s["attrs"]["metric"] == "BinaryAccuracy"
               for s in obs.TRACER.spans())


# --------------------------------------------------------------------------- trace ids across the WAL


def _port_engine(directory, start=True):
    return StreamingEngine(BinaryAccuracy(device="cpu"), buckets=(8,),
                           checkpoint=CheckpointConfig(directory=directory, interval_s=3600.0, durable=False),
                           start=start)


def _jax_engine(directory, start=True):
    return JaxEngine(jcls.BinaryAccuracy(), buckets=(8,),
                     checkpoint=JaxCheckpointConfig(directory=directory, interval_s=3600.0, durable=False),
                     start=start)


@pytest.mark.parametrize("route", ["chunk", "request"])
def test_a_port_journal_replayed_by_the_jax_engine_names_the_submitting_trace(route, tmp_path):
    """``chunk``: the dispatcher coalesces C records; ``request``: an engine
    without a dispatcher journals one R record a submit."""
    obs.enable()
    port = _port_engine(str(tmp_path), start=route == "chunk")
    minted = []
    try:
        for key, preds, target in _rows(1, 12):
            ctx = tctx.mint()
            minted.append(ctx.trace_hex)
            with tctx.activate(ctx):
                port.submit(key, preds, target).result(timeout=WAIT_S)
        want = {k: port._keyed.state_of(k) for k in port._keyed.keys}
        assert _replay_trace_ids(obs.TRACER.spans()) == set()
    finally:
        port.close(checkpoint=False)
    jobs.enable()
    ref = _jax_engine(str(tmp_path), start=False)
    try:
        assert _replay_trace_ids(jobs.TRACER.spans()) == set(minted)
        kinds = {s["attrs"]["kind"] for s in jobs.TRACER.spans() if s["name"] == "engine.replay"}
        assert kinds == ({"C"} if route == "chunk" else {"R"})
        for key, state in want.items():
            assert_trees_match(state, ref._keyed.state_of(key), key)
    finally:
        ref.close(checkpoint=False)


@pytest.mark.parametrize("route", ["chunk", "request"])
def test_a_jax_journal_replayed_by_the_port_engine_names_the_submitting_trace(route, tmp_path):
    jobs.enable()
    ref = _jax_engine(str(tmp_path), start=route == "chunk")
    minted = []
    try:
        for key, preds, target in _rows(2, 12):
            ctx = jctx.mint()
            minted.append(ctx.trace_hex)
            with jctx.activate(ctx):
                ref.submit(key, preds, target).result(timeout=WAIT_S)
        want = {k: ref._keyed.state_of(k) for k in ref._keyed.keys}
    finally:
        ref.close(checkpoint=False)
    obs.enable()
    port = _port_engine(str(tmp_path), start=False)
    try:
        assert _replay_trace_ids(obs.TRACER.spans()) == set(minted)
        for key, state in want.items():
            assert_trees_match(port._keyed.state_of(key), state, key)
    finally:
        port.close(checkpoint=False)


def test_obs_off_journals_no_trailer_and_replays_unchanged(tmp_path):
    port = _port_engine(str(tmp_path))
    try:
        for key, preds, target in _rows(3, 6):
            port.submit(key, preds, target).result(timeout=WAIT_S)
        seq = port._wal_seq
    finally:
        port.close(checkpoint=False)
    obs.enable()
    again = _port_engine(str(tmp_path), start=False)
    try:
        spans = [s for s in obs.TRACER.spans() if s["name"] == "engine.replay"]
        assert len(spans) == seq + 1 and not any("traces" in s["attrs"] for s in spans)
    finally:
        again.close(checkpoint=False)


def test_a_follower_replay_names_the_primary_submit_trace(tmp_path):
    obs.enable()
    link = LoopbackLink()
    primary = StreamingEngine(
        BinaryAccuracy(device="cpu"), buckets=(8,),
        checkpoint=CheckpointConfig(directory=str(tmp_path / "p"), interval_s=3600.0, durable=False),
        replication=ReplConfig(role="primary", transport=link, ship_interval_s=0.01, heartbeat_interval_s=0.05))
    follower = StreamingEngine(BinaryAccuracy(device="cpu"), buckets=(8,),
                               replication=ReplConfig(role="follower", transport=link, poll_interval_s=0.01))
    try:
        ctx = tctx.mint()
        with tctx.activate(ctx):
            primary.submit("t0", np.array([1, 1], np.int32), np.array([1, 0], np.int32)).result(timeout=WAIT_S)
        assert follower._applier.await_seq(primary._wal_seq, timeout_s=WAIT_S)
        replays = [s for s in obs.TRACER.spans() if s["name"] == "engine.replay"]
        assert ctx.trace_hex in _replay_trace_ids(replays)
        assert any(s["thread_name"] == "metrics-tpu-repl-apply" for s in replays)
        # the primary's heartbeat carries its node snapshot to the follower's aggregator
        deadline = time.monotonic() + WAIT_S
        while not AGGREGATOR.nodes() and time.monotonic() < deadline:
            time.sleep(0.01)
        node = f"primary:{primary.telemetry.engine_id}"
        assert node in AGGREGATOR.nodes()
        assert "metrics_tpu_torch_repl_shipped_records_total" in AGGREGATOR.render_prometheus()
        assert any(s["name"] == "engine.dispatch" for s in obs.TRACER.spans())
    finally:
        primary.close(checkpoint=False)
        follower.close()


# --------------------------------------------------------------------------- flight bundles


def test_triggers_and_bundle_header_are_the_jax_packages():
    assert TRIGGERS == jflight.TRIGGERS
    assert (BUNDLE_KIND, obs.flight.BUNDLE_VERSION) == (jflight.BUNDLE_KIND, jflight.BUNDLE_VERSION)


def _quarantine(engine, poison, wrap):
    p, t = poison
    for _ in range(2):
        engine.submit("poison", wrap(p), wrap(t)).exception(timeout=WAIT_S)
        engine.flush()


def test_a_guard_quarantine_dumps_one_bundle_both_packages_load(tmp_path):
    obs.enable()
    FLIGHT.configure(directory=str(tmp_path / "port"))
    engine = StreamingEngine(BinaryAccuracy(device="cpu"), buckets=(8,), capacity=4,
                             guard=GuardConfig(quarantine_threshold=2))
    try:
        _quarantine(engine, poison_args(), np.asarray)
        assert FLIGHT.dump_counts() == {"guard_quarantine": 1}
        bundle = FLIGHT.bundles()[-1]
        assert any(e["kind"] == "guard_quarantine" for e in bundle["events"])
        ctx = bundle["contexts"][f"engine:{engine.telemetry.engine_id}"]
        assert ctx["engine"] == engine.telemetry.engine_id and not ctx["repl_follower"]
        for load in (load_bundle, jflight.load_bundle):
            loaded = load(bundle["path"])
            assert loaded["trigger"] == "guard_quarantine" and loaded["serial"] == bundle["serial"]
    finally:
        engine.close()
    assert f"engine:{engine.telemetry.engine_id}" not in FLIGHT._providers  # close() unregisters


def test_the_jax_guard_quarantines_at_the_same_edge_and_its_bundle_loads_in_the_port(tmp_path):
    """The two guards fire ``guard_quarantine`` after the same failures: once
    each, on the second poisoned request."""
    jobs.enable()
    jflight.FLIGHT.configure(directory=str(tmp_path / "jax"))
    ref = JaxEngine(jcls.BinaryAccuracy(), buckets=(8,), capacity=4, guard=JaxGuardConfig(quarantine_threshold=2))
    try:
        import jax.numpy as jnp

        p, t = jax_poison_args()
        ref.submit("poison", jnp.asarray(p), jnp.asarray(t)).exception(timeout=WAIT_S)
        ref.flush()
        assert jflight.FLIGHT.dump_counts() == {}
        ref.submit("poison", jnp.asarray(p), jnp.asarray(t)).exception(timeout=WAIT_S)
        ref.flush()
        assert jflight.FLIGHT.dump_counts() == {"guard_quarantine": 1}
        loaded = load_bundle(jflight.FLIGHT.bundles()[-1]["path"])
        assert loaded["trigger"] == "guard_quarantine" and loaded["bundle"] == BUNDLE_KIND
    finally:
        ref.close()
        jflight.FLIGHT.configure(directory=None)
    obs.enable()
    engine = StreamingEngine(BinaryAccuracy(device="cpu"), buckets=(8,), capacity=4,
                             guard=GuardConfig(quarantine_threshold=2))
    try:
        p, t = poison_args()
        engine.submit("poison", p, t).exception(timeout=WAIT_S)
        engine.flush()
        assert FLIGHT.dump_counts() == {}
        engine.submit("poison", p, t).exception(timeout=WAIT_S)
        engine.flush()
        assert FLIGHT.dump_counts() == {"guard_quarantine": 1}
    finally:
        engine.close()


def test_load_bundle_refuses_what_is_not_a_bundle(tmp_path):
    path = tmp_path / "x.json"
    path.write_text(json.dumps({"bundle": "other"}))
    with pytest.raises(ValueError):
        load_bundle(str(path))


def test_a_watchdog_restart_dumps_exactly_once():
    obs.enable()
    engine = StreamingEngine(BinaryAccuracy(device="cpu"), buckets=(8,), capacity=4, guard=GuardConfig())
    try:
        kill_dispatcher(engine)
        engine.submit("k", np.array([1], np.int32), np.array([1], np.int32)).result(timeout=WAIT_S)
        deadline = time.monotonic() + WAIT_S
        while engine.telemetry_snapshot()["watchdog_restarts"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert FLIGHT.dump_counts().get("watchdog_restart") == 1
    finally:
        engine.close()


def test_a_breaker_open_edge_dumps_once_per_edge_not_per_refresh():
    obs.enable()
    engine = StreamingEngine(BinaryAccuracy(device="cpu"), buckets=(8,), capacity=4,
                             guard=GuardConfig(breaker_failure_threshold=2))
    try:
        breaker = engine._guard.comm_breaker
        breaker.record_failure()
        breaker.record_failure()  # -> open: one bundle
        engine.health()
        engine.health()
        assert FLIGHT.dump_counts().get("breaker_open") == 1
        breaker.record_success()
        breaker.record_failure()
        breaker.record_failure()
        assert FLIGHT.dump_counts().get("breaker_open") == 2
    finally:
        engine.close()


def test_an_engine_quarantine_transition_dumps_a_bundle():
    obs.enable()
    engine = StreamingEngine(BinaryAccuracy(device="cpu"), buckets=(8,), capacity=4, guard=GuardConfig())
    try:
        engine._quarantine_engine([])
        assert FLIGHT.dump_counts().get("engine_quarantine") == 1
        assert any(e["kind"] == "health_transition" and e["new"] == "QUARANTINED" for e in FLIGHT.events())
    finally:
        engine.close()


def test_obs_off_records_nothing_and_reset_clears_every_store():
    FLIGHT.record("x")
    assert FLIGHT.dump("guard_quarantine") is None and FLIGHT.events() == []
    obs.enable()
    with obs.span("s"):
        pass
    FLIGHT.dump("guard_quarantine")
    AGGREGATOR.ingest(node_snapshot("n"))
    obs.reset()
    assert obs.TRACER.spans() == [] and FLIGHT.bundles() == [] and AGGREGATOR.nodes() == {}
    assert not obs.enabled()


# --------------------------------------------------------------------------- fleet telemetry


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _seed(pkg, prefix):
    pkg.counter(f"{prefix}_fleet_test_total").inc(3, site="update", signature="f32[8,2],i32[]")
    pkg.histogram(f"{prefix}_fleet_test_hist", buckets=(0.1, 1.0)).observe(0.5, k="v")


def test_node_snapshots_merge_in_both_aggregators():
    obs.enable()
    jobs.enable()
    _seed(obs, "port")
    _seed(jobs, "jax")
    port_snap, jax_snap = node_snapshot("port-host"), jfleet.node_snapshot("jax-host")
    assert port_snap["kind"] == jax_snap["kind"] == SNAPSHOT_KIND
    assert port_snap["families"]["port_fleet_test_total"]["samples"] == \
        jax_snap["families"]["jax_fleet_test_total"]["samples"]
    port_hist = port_snap["families"]["port_fleet_test_hist"]["samples"]
    assert port_hist == jax_snap["families"]["jax_fleet_test_hist"]["samples"]
    pages = []
    for agg in (FleetAggregator(), jfleet.FleetAggregator()):
        agg.ingest(port_snap)
        agg.ingest(jax_snap)
        agg.ingest({"kind": "garbage"})
        assert set(agg.nodes()) == {"port-host", "jax-host"}
        pages.append(agg.render_prometheus())
    for page in pages:
        assert 'port_fleet_test_total{node="port-host",signature="f32[8,2],i32[]",site="update"} 3' in page
        assert 'jax_fleet_test_hist_bucket{node="jax-host",k="v",le="1"} 1' in page


def test_stale_then_retired_nodes():
    clock = _Clock()
    agg = FleetAggregator(stale_after_s=1.0, retire_after_s=3.0, clock=clock)
    agg.ingest(node_snapshot("a"))
    assert agg.nodes()["a"]["stale"] is False
    clock.t = 2.0
    assert agg.nodes()["a"]["stale"] is True
    assert 'metrics_tpu_torch_fleet_node_stale{node="a"} 1' in agg.render_prometheus()
    clock.t = 4.0
    assert agg.nodes() == {} and agg.retired() == ["a"]
    assert agg.snapshot()["retired"] == ["a"]
    with pytest.raises(ValueError):
        FleetAggregator(stale_after_s=2.0, retire_after_s=1.0)
