"""The port's guard policies (``metrics_tpu_torch/guard/``) against the JAX
package's (``metrics_tpu/guard/``), on the CPU.

Every policy of the guard plane is plain Python in both packages, driven by an
injected clock. Each case builds the same policy in both packages, each with its
own package's ``ManualClock``, and runs one script of operations on both: clock
advances interleaved with the policy's calls. Every call's result (and, after
each step, the policy's observable state) goes into a decision trace, and the two
traces must be equal, element for element — no tolerance: the decisions are
discrete and the clock values are the same floats in both.

Scripts come from hypothesis (``derandomize=True``, so each run draws the same
cases) and from a few fixed scripts that reach each state machine's corners (a
breaker's half-open probe, a quarantine's failed probe, CoDel's escalation, the
fair drain's start rotation across drains).
"""

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import metrics_tpu.guard as jg
import metrics_tpu.guard.faults as jfaults
import metrics_tpu_torch.guard as tg
import metrics_tpu_torch.guard.faults as tfaults

PACKAGES = ((jg, jfaults), (tg, tfaults))
SETTINGS = settings(max_examples=60, derandomize=True, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])

# a clock step: mostly small, sometimes past every probation and refill
DT = st.sampled_from([0.0, 0.01, 0.05, 0.1, 0.3, 0.5, 1.0, 2.5, 10.0])
KEYS = st.sampled_from(["a", "b", "c"])


def run_both(build, script, step, observe=None):
    """``build(pkg, clock)`` in both packages; ``step(policy, clock, op)`` for each
    op of ``script``; returns the two decision traces."""
    traces = []
    for pkg, faults in PACKAGES:
        clock = faults.ManualClock(100.0)
        policy = build(pkg, clock)
        trace = []
        for op in script:
            trace.append(step(policy, clock, op))
            if observe is not None:
                trace.append(observe(policy))
        traces.append(trace)
    return traces


def assert_same(traces):
    jax_trace, port_trace = traces
    assert len(jax_trace) == len(port_trace)
    for i, (want, got) in enumerate(zip(jax_trace, port_trace)):
        assert got == want, f"step {i}: port {got!r} vs JAX {want!r}"


# --------------------------------------------------------------------------- token buckets


def _bucket_step(bucket, clock, op):
    kind, arg = op
    if kind == "advance":
        return clock.advance(arg)
    if kind == "take":
        return bucket.try_take(arg)
    return round(bucket.available(), 12)


BUCKET_OPS = st.lists(st.one_of(st.tuples(st.just("advance"), DT),
                                st.tuples(st.just("take"), st.sampled_from([0.5, 1.0, 2.0, 5.0, 20.0])),
                                st.tuples(st.just("available"), st.none())), max_size=40)


@SETTINGS
@given(rate=st.sampled_from([0.0, 0.5, 3.0, 100.0]), burst=st.sampled_from([1.0, 4.0, 30.0]), script=BUCKET_OPS)
def test_token_bucket_decisions_match_jax(rate, burst, script):
    assert_same(run_both(lambda pkg, clock: pkg.TokenBucket(rate, burst, clock), script, _bucket_step))


def test_token_bucket_refuses_what_jax_refuses():
    for pkg in (jg, tg):
        with pytest.raises(ValueError):
            pkg.TokenBucket(-1.0, 1.0, lambda: 0.0)
        with pytest.raises(ValueError):
            pkg.TokenBucket(1.0, 0.0, lambda: 0.0)


def _quota_step(quotas, clock, op):
    kind, key, rows = op
    if kind == "advance":
        return clock.advance(rows)
    return quotas.admit(key, rows)


QUOTA_OPS = st.lists(st.one_of(st.tuples(st.just("advance"), st.none(), DT),
                               st.tuples(st.just("admit"), KEYS, st.sampled_from([1, 2, 8, 64]))), max_size=40)


@SETTINGS
@given(rate=st.sampled_from([None, 0.0, 5.0, 50.0]), burst=st.sampled_from([None, 8.0, 100.0]),
       overrides=st.sampled_from([{}, {"a": 0.0}, {"b": 1000.0}, {"a": 2.0, "c": 0.0}]), script=QUOTA_OPS)
def test_tenant_quotas_decisions_match_jax(rate, burst, overrides, script):
    assert_same(run_both(lambda pkg, clock: pkg.TenantQuotas(rate, burst, overrides, clock), script, _quota_step,
                         observe=lambda q: q.enabled))


# --------------------------------------------------------------------------- breakers


def _breaker_step(breaker, clock, op):
    kind, dt = op
    if kind == "advance":
        return clock.advance(dt)
    if kind == "state":
        return breaker.state
    return getattr(breaker, kind)()


BREAKER_OPS = st.lists(st.one_of(st.tuples(st.just("advance"), DT),
                                 st.tuples(st.sampled_from(["permit", "record_success", "record_failure",
                                                            "abandon_probe", "state"]), st.none())),
                       max_size=50)


def _breaker(pkg, clock, transitions):
    return pkg.CircuitBreaker("compile", failure_threshold=2, probation_s=0.5, probation_max_s=3.0,
                              probation_factor=2.0, clock=clock,
                              on_transition=lambda name, old, new: transitions.append((name, old, new)))


@SETTINGS
@given(script=BREAKER_OPS)
def test_circuit_breaker_decisions_and_transitions_match_jax(script):
    transitions = {}

    def build(pkg, clock):
        transitions[pkg.__name__] = []
        return _breaker(pkg, clock, transitions[pkg.__name__])

    assert_same(run_both(build, script, _breaker_step, observe=lambda b: b.snapshot()))
    assert transitions["metrics_tpu_torch.guard"] == transitions["metrics_tpu.guard"]


def test_breaker_walks_open_half_open_and_back_as_jax_does():
    """Two failures trip it; the probation doubles on a failed probe, caps at
    3 s, and a successful probe closes it and resets the ladder."""
    script = ([("record_failure", None)] * 2 + [("permit", None), ("advance", 0.5), ("state", None),
              ("permit", None), ("permit", None), ("record_failure", None), ("advance", 0.6), ("permit", None),
              ("advance", 0.5), ("permit", None), ("abandon_probe", None), ("permit", None),
              ("record_failure", None), ("advance", 5.0), ("permit", None), ("record_success", None),
              ("state", None), ("record_failure", None), ("record_failure", None), ("state", None)])
    traces = run_both(lambda pkg, clock: _breaker(pkg, clock, []), script, _breaker_step,
                      observe=lambda b: b.snapshot())
    assert_same(traces)
    assert "half_open" in traces[1] and traces[1][-2] == "open"


@SETTINGS
@given(rate=st.sampled_from([0.0, 1.0, 2.0, 20.0]), burst=st.sampled_from([1.0, 2.0, 16.0]),
       script=st.lists(st.one_of(st.tuples(st.just("advance"), DT), st.tuples(st.just("miss"), st.none())),
                       max_size=50))
def test_capture_governor_decisions_match_jax(rate, burst, script):
    """The governor of graph captures in the port is the JAX package's compile
    governor: the same token bucket behind the same breaker."""
    def build(pkg, clock):
        return pkg.CompileGovernor(rate, burst, _breaker(pkg, clock, []))

    def step(gov, clock, op):
        return clock.advance(op[1]) if op[0] == "advance" else gov.allow_compile()

    assert_same(run_both(build, script, step, observe=lambda g: g.breaker.snapshot()))


# --------------------------------------------------------------------------- shedding


@SETTINGS
@given(target=st.sampled_from([0.05, 0.1]), interval=st.sampled_from([0.1, 1.0]),
       script=st.lists(st.tuples(DT, st.sampled_from([0.0, 0.02, 0.08, 0.2, 1.5])), max_size=40))
def test_codel_shedder_decisions_match_jax(target, interval, script):
    def step(shedder, clock, op):
        dt, sojourn = op
        clock.advance(dt)
        return shedder.on_drain(sojourn)

    assert_same(run_both(lambda pkg, clock: pkg.CoDelShedder(target, interval, clock), script, step,
                         observe=lambda s: (s.dropping, s.drop_count)))


def test_codel_escalates_one_more_each_overloaded_drain():
    script = [(0.0, 0.5), (0.2, 0.5), (1.0, 0.5), (0.1, 0.5), (0.1, 0.5), (0.1, 0.01), (0.1, 0.5)]
    traces = run_both(lambda pkg, clock: pkg.CoDelShedder(0.1, 1.0, clock), script,
                      lambda s, clock, op: (clock.advance(op[0]), s.on_drain(op[1]))[1])
    assert_same(traces)
    assert traces[1] == [0, 0, 1, 2, 3, 0, 0]


# --------------------------------------------------------------------------- fair drain


class _Req:
    __slots__ = ("key", "rows", "uid", "deadline", "priority", "t_enqueue")

    def __init__(self, key, rows, uid, deadline=None, priority=0, t_enqueue=0.0):
        self.key, self.rows, self.uid = key, rows, uid
        self.deadline, self.priority, self.t_enqueue = deadline, priority, t_enqueue


REQS = st.lists(st.tuples(st.sampled_from(["heavy", "l0", "l1", "l2"]), st.integers(1, 64),
                          st.sampled_from([None, None, 1.0, 5.0]), st.integers(0, 1)), min_size=1, max_size=60)


def _requests(spec):
    return [_Req(key, rows, uid, deadline, priority, float(uid)) for uid, (key, rows, deadline, priority)
            in enumerate(spec)]


@SETTINGS
@given(spec=REQS, quantum=st.sampled_from([None, 1, 16, 64, 200]),
       weights=st.sampled_from([{}, {"heavy": 0.25}, {"l0": 3.0, "heavy": 0.5}]))
def test_fair_order_matches_jax(spec, quantum, weights):
    traces = []
    for pkg, _ in PACKAGES:
        selected, kept = pkg.fair_order(_requests(spec), weights=weights, quantum_rows=quantum)
        traces.append([[r.uid for r in selected], [r.uid for r in kept]])
    assert traces[0] == traces[1]


def _backlog_trace(pkg, batches, quantum, weights, fair, now):
    backlog = pkg.FairBacklog(weights, quantum) if fair else pkg.FifoBacklog(quantum)
    trace = []
    for kind, spec in batches:
        if kind == "ingest":
            backlog.ingest(spec)
        elif kind == "shed":
            trace.append(("shed", [r.uid for r in backlog.shed_oldest(0, spec)]))
        else:
            selected, rejected = backlog.select(reject=lambda r: r.deadline is not None and now >= r.deadline)
            trace.append(("select", [r.uid for r in selected], [r.uid for r in rejected]))
        trace.append((backlog.rows, backlog.count, backlog.newest_enqueue(),
                      {k: backlog.pending_for(k) for k in ("heavy", "l0", "l1", "l2")}))
    trace.append(("rest", [r.uid for r in backlog.take_all()]))
    return trace


@SETTINGS
@given(chunks=st.lists(st.tuples(st.sampled_from(["ingest", "select", "select", "shed"]), REQS, st.integers(1, 3)),
                       min_size=1, max_size=8),
       quantum=st.sampled_from([None, 8, 64]), fair=st.booleans(), now=st.sampled_from([0.0, 2.0, 10.0]))
def test_backlog_drains_match_jax(chunks, quantum, fair, now):
    """Ingest, select (with lazy deadline expiry), shed and take-all on a
    persistent backlog, fair and FIFO: the same requests come out in the same
    order, drain after drain, with the same bookkeeping."""
    uid = 0
    batches = []
    for kind, spec, n in chunks:
        if kind == "ingest":
            reqs = _requests(spec)
            for r in reqs:
                r.uid, r.t_enqueue = uid, float(uid)
                uid += 1
            batches.append(("ingest", reqs))
        else:
            batches.append((kind, n))
    traces = [_backlog_trace(pkg, batches, quantum, {"heavy": 0.5}, fair, now) for pkg, _ in PACKAGES]
    assert traces[0] == traces[1]


def test_fair_drain_rotates_its_start_across_drains_as_jax_does():
    """A quantum smaller than one round: the service cursor rotates, so every
    tenant is served in turn, in the same order in both packages."""
    spec = [(f"t{i % 5}", 4, None, 0) for i in range(40)]
    batches = [("ingest", _requests(spec))] + [("select", 1)] * 12
    traces = [_backlog_trace(pkg, batches, 8, {}, True, 0.0) for pkg, _ in PACKAGES]
    assert traces[0] == traces[1]


# --------------------------------------------------------------------------- quarantine


def _quarantine_step(q, clock, op):
    kind, key, arg = op
    if kind == "advance":
        return clock.advance(arg)
    if kind == "record":
        return q.record(key, arg)
    return getattr(q, kind)(key)


QUARANTINE_OPS = st.lists(st.one_of(
    st.tuples(st.just("advance"), st.none(), DT),
    st.tuples(st.just("record"), KEYS, st.booleans()),
    st.tuples(st.sampled_from(["check", "abandon", "is_quarantined", "is_held", "hold", "release"]), KEYS,
              st.none())), max_size=60)


@SETTINGS
@given(script=QUARANTINE_OPS)
def test_tenant_quarantine_decisions_match_jax(script):
    def build(pkg, clock):
        return pkg.TenantQuarantine(threshold=2, probation_s=0.5, probation_max_s=4.0, probation_factor=2.0,
                                    clock=clock)

    assert_same(run_both(build, script, _quarantine_step, observe=lambda q: sorted(q.active().items())))


def test_quarantine_probe_ladder_matches_jax():
    """Two failures quarantine; DENY until the probation lapses; one PROBE; a
    failed probe doubles the probation; a good probe forgives."""
    script = [("record", "a", False), ("record", "a", False), ("check", "a", None), ("advance", None, 0.6),
              ("check", "a", None), ("check", "a", None), ("record", "a", False), ("advance", None, 0.6),
              ("check", "a", None), ("advance", None, 0.5), ("check", "a", None), ("record", "a", True),
              ("check", "a", None), ("hold", "b", None), ("check", "b", None), ("record", "b", True),
              ("is_held", "b", None), ("release", "b", None), ("check", "b", None)]
    traces = run_both(lambda pkg, clock: pkg.TenantQuarantine(threshold=2, probation_s=0.5, clock=clock), script,
                      _quarantine_step, observe=lambda q: sorted(q.active().items()))
    assert_same(traces)
    decisions = [d for d in traces[1][::2] if d in ("allow", "probe", "deny")]
    assert decisions == ["deny", "probe", "deny", "deny", "probe", "allow", "deny", "allow"]


# --------------------------------------------------------------------------- watchdog policy


@SETTINGS
@given(timeout=st.sampled_from([0.1, 1.0]),
       script=st.lists(st.sampled_from(["busy", "idle", "hung", "tick", "wait"]), max_size=40))
def test_hang_detector_decisions_match_jax(timeout, script):
    def step(det, clock, op):
        if op == "busy":
            return det.mark_busy()
        if op == "idle":
            return det.mark_idle()
        if op == "hung":
            return det.hung()
        return clock.advance(0.04 if op == "tick" else 0.7)

    assert_same(run_both(lambda pkg, clock: pkg.HangDetector(timeout, clock=clock), script, step))


def test_manual_clock_matches_jax():
    for pkg, faults in PACKAGES:
        clock = faults.ManualClock(3.0)
        assert (clock(), clock.advance(0.5), clock.set(10.0), clock()) == (3.0, 3.5, 10.0, 10.0)


# --------------------------------------------------------------------------- configuration


@pytest.mark.parametrize("kwargs", [
    {"quota_rows_per_s": -1.0}, {"shed_target_s": 0.0}, {"shed_interval_s": -1.0},
    {"breaker_failure_threshold": 0}, {"quarantine_threshold": 0}, {"drain_quantum_rows": 0},
    {"tenant_weights": {"a": 0.0}},
])
def test_guard_config_refuses_what_jax_refuses(kwargs):
    for pkg in (jg, tg):
        with pytest.raises(ValueError):
            pkg.GuardConfig(**kwargs)


def test_guard_config_defaults_match_jax():
    want, got = jg.GuardConfig(), tg.GuardConfig()
    fields = [f for f in want.__dataclass_fields__ if f not in ("clock", "on_health_transition")]
    assert list(got.__dataclass_fields__) == list(want.__dataclass_fields__)
    assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}


def test_guard_exports_and_errors_match_jax():
    assert sorted(tg.__all__) == sorted(jg.__all__)
    assert tg.BREAKER_STATE_CODES == jg.BREAKER_STATE_CODES
    from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

    for name in ("QuotaExceeded", "DeadlineExceeded", "RequestShed", "TenantQuarantined", "EngineQuarantined"):
        assert issubclass(getattr(tg, name), tg.GuardRejected)
        assert issubclass(getattr(tg, name), MetricsTPUUserError)


class _Tel:
    engine_id = "7"

    def __init__(self):
        self.counts = {}

    def count(self, name, n=1):
        self.counts[name] = self.counts.get(name, 0) + n


@SETTINGS
@given(spec=REQS, quantum=st.sampled_from([None, 16, 128]), shed=st.booleans(),
       advances=st.lists(DT, min_size=1, max_size=5))
def test_guard_plane_drains_match_jax(spec, quantum, shed, advances):
    """``GuardPlane.form_drain`` over several drains with the clock moving:
    the same batches, the same rejections by type, the same counts."""
    traces = []
    for pkg, faults in PACKAGES:
        clock = faults.ManualClock(0.0)
        tel = _Tel()
        plane = pkg.GuardPlane(pkg.GuardConfig(clock=clock, shed=shed, shed_target_s=0.05, shed_interval_s=0.1,
                                               drain_quantum_rows=quantum), telemetry=tel, max_rows=8)
        reqs = _requests(spec)
        for r in reqs:
            r.t_enqueue = 0.0
            if r.deadline is not None:
                r.deadline = float(r.deadline)
        trace, first = [], True
        for dt in advances:
            clock.advance(dt)
            batch, rejected = plane.form_drain(reqs if first else [])
            first = False
            trace.append(([r.uid for r in batch], [(r.uid, type(e).__name__) for r, e in rejected]))
        trace.append(sorted(tel.counts.items()))
        traces.append(trace)
    assert traces[0] == traces[1]
