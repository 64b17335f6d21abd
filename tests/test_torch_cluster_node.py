"""The port's cluster plane (``ClusterNode``, ``ClusterClient``, the engine's
``_cluster`` hook) against the JAX package's, on the CPU.

A ``TriCluster`` twin in each package (the JAX tests' three-node rig,
``tests/cluster/conftest.py``: 'a' a checkpointed primary shipping through a
``FanoutTransport`` of ``LoopbackLink``s, 'b' and 'c' followers with
``promote_checkpoint``), its nodes built with ``start=False`` and ticked by one
script under one ``ManualClock`` step each. After every tick the two packages
show the same roles, lease holder and epoch, failovers, suspicions,
``health_view()`` and ``engine.health()["cluster"]``; once the followers have
caught up, every engine's states are equal leaf for leaf (``SumMetric`` and
the flagship collection at C = 10). The deposed leader's late shipment is
fenced in both. ``ClusterClient`` with a seeded ``rng_seed`` takes the same
redirects and the same backoff sleeps, and a stub-engine detector script (the
heartbeats, the comm plane's suspicion edges through ``WorldView``, store
partitions) gives the same health trace and the same obs series. Every wait
on a ship or apply thread has a deadline that fails the test.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest

import metrics_tpu as jm
import metrics_tpu.cluster as jc
import metrics_tpu.comm as jcomm
import metrics_tpu.engine as jeng
import metrics_tpu.repl as jrepl
import metrics_tpu_torch as tm
import metrics_tpu_torch.cluster as tc
import metrics_tpu_torch.comm as tcomm
import metrics_tpu_torch.engine as teng
import metrics_tpu_torch.repl as trepl
from metrics_tpu_torch import obs
from tests.test_torch_engine import _flagship, _one_torch_thread, assert_trees_match, engine_states  # noqa: F401

WAIT_S = 20
NODES = ("a", "b", "c")
C = 10
PKG = {
    "jax": SimpleNamespace(top=jm, cluster=jc, engine=jeng, repl=jrepl, comm=jcomm, cpu={}),
    "port": SimpleNamespace(top=tm, cluster=tc, engine=teng, repl=trepl, comm=tcomm, cpu={"device": "cpu"}),
}


def make_metric(family, pkg):
    p = PKG[pkg]
    return p.top.SumMetric(**p.cpu) if family == "sum" else _flagship(p.top, **p.cpu)


def requests(family, seed, n):
    """``n`` requests of tenant 'k' (and 'j' for the collection), numpy."""
    rng = np.random.default_rng(seed)
    if family == "sum":
        return [("k", (np.array([float(rng.integers(0, 100))], np.float32),)) for _ in range(n)]
    out = []
    for _ in range(n):
        rows = int(rng.integers(1, 7))
        out.append((str(rng.choice(["k", "j"])), (rng.integers(0, C, rows).astype(np.int32),
                                                   rng.integers(0, C, rows).astype(np.int32))))
    return out


class TriCluster:
    """Three engines of one package ('a' primary, 'b'/'c' followers) and their
    ClusterNodes, ticked by hand under a ManualClock."""

    def __init__(self, pkg, root, family):
        p = self.p = PKG[pkg]
        self.clock = p.cluster.ManualClock(0.0)
        self.store = p.cluster.FakeCoordStore(clock=self.clock)
        self._links = {}
        self.engines, self.nodes, self.transitions = {}, {}, []
        self.engines["a"] = p.engine.StreamingEngine(
            make_metric(family, pkg), buckets=(8, 32),
            checkpoint=p.engine.CheckpointConfig(directory=str(root / "a"), interval_s=0.05, wal_flush="fsync"),
            replication=p.engine.ReplConfig(
                role="primary", transport=p.repl.FanoutTransport([self.link("a", "b"), self.link("a", "c")]),
                ship_interval_s=0.01, heartbeat_interval_s=0.05),
        )
        for name in ("b", "c"):
            self.engines[name] = p.engine.StreamingEngine(
                make_metric(family, pkg), buckets=(8, 32),
                replication=p.engine.ReplConfig(
                    role="follower", transport=self.link("a", name), poll_interval_s=0.01,
                    promote_checkpoint=p.engine.CheckpointConfig(
                        directory=str(root / name), interval_s=0.05, wal_flush="fsync")),
            )
        for name in NODES:
            self.nodes[name] = p.cluster.ClusterNode(
                self.engines[name],
                p.cluster.ClusterConfig(
                    node_id=name, peers=tuple(n for n in NODES if n != name), store=self.store,
                    link_factory=self.link, lease_ttl_s=3.0, heartbeat_interval_s=1.0, suspect_after_s=2.5,
                    confirm_after_s=6.0, election_backoff_s=0.25, rng_seed=ord(name),
                    on_transition=lambda old, new, name=name: self.transitions.append((name, old, new))),
                start=False,
            )

    def link(self, src, dst):
        return self._links.setdefault((src, dst), self.p.repl.LoopbackLink())

    def writable(self):
        return [n for n in NODES if not self.engines[n]._repl_follower]

    def feed(self, leader, reqs):
        for key, args in reqs:
            self.engines[leader].submit(key, *args)
        self.engines[leader].flush()

    def wait_caught_up(self, follower, leader):
        target = self.engines[leader]._wal_seq
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            applier = self.engines[follower]._applier
            if applier is not None and applier.bootstrapped and applier.applied_seq >= target:
                return
            time.sleep(0.01)
        raise AssertionError(f"{follower} never caught up to {leader}'s seq {target}")

    def observe(self):
        lease = self.store.read_lease()
        return {
            "lease": None if lease is None else (lease.holder, lease.epoch, lease.deadline),
            "writable": self.writable(),
            "transitions": list(self.transitions),
            **{name: {"role": node.role, "failovers": node.failovers, "suspicions": node.suspicions,
                      "renewals": node.lease_renewals, "following": node._following,
                      "error": type(node.last_error).__name__ if node.last_error is not None else None,
                      "health_view": node.health_view(),
                      "engine_cluster": self.engines[name].health()["cluster"],
                      "epoch": int(self.engines[name]._repl_epoch)}
               for name, node in self.nodes.items()},
        }

    def close(self):
        for node in self.nodes.values():
            node.close(release=False)
        for engine in self.engines.values():
            engine.close()


class Twins:
    """A TriCluster of each package, driven step by step by one script."""

    def __init__(self, root, family):
        self.family = family
        self.jax = TriCluster("jax", root / "jax", family)
        self.port = TriCluster("port", root / "port", family)

    def both(self, fn):
        return fn(self.jax), fn(self.port)

    def advance(self, dt):
        self.both(lambda t: t.clock.advance(dt))

    def tick(self, *names):
        for name in names or NODES:
            self.both(lambda t: t.nodes[name].tick())
            self.check()

    def check(self):
        want, got = self.jax.observe(), self.port.observe()
        assert got == want, (got, want)

    def check_states(self, *names):
        for name in names or NODES:
            j, p = engine_states(self.jax.engines[name]), engine_states(self.port.engines[name])
            assert set(p) == set(j), (name, sorted(p), sorted(j))
            for key in j:
                assert_trees_match(p[key], j[key], f"{name}/{key}")

    def feed(self, leader, reqs):
        self.both(lambda t: t.feed(leader, reqs))

    def wait(self, follower, leader):
        self.both(lambda t: t.wait_caught_up(follower, leader))

    def close(self):
        self.both(lambda t: t.close())


@pytest.fixture
def twins(tmp_path):
    made = []

    def make(family):
        made.append(Twins(tmp_path / str(len(made)), family))
        return made[-1]

    yield make
    for t in made:
        t.close()


# --------------------------------------------------------------------------- the failover script


@pytest.mark.parametrize("family", ["sum", "flagship"])
def test_failover_zombie_and_rejoin_trace_equal_across_packages(twins, family):
    tw = twins(family)
    tw.tick()  # formation: 'a' takes the lease, 'b' and 'c' attach
    assert tw.port.store.read_lease().holder == "a" and tw.port.engines["a"]._repl_epoch == 1
    tw.feed("a", requests(family, 1, 24))
    tw.wait("b", "a")
    tw.wait("c", "a")
    tw.check_states()
    tw.advance(1.0)
    tw.tick()
    # the leader goes dark: cut from the store, its lease expires
    tw.both(lambda t: t.store.partition("a"))
    tw.advance(3.5)
    tw.tick("b", "c")
    assert tw.port.nodes["b"].role == "leader" and tw.port.store.read_lease().epoch == 2
    assert tw.port.nodes["c"]._following == "b" and tw.port.writable() == ["a", "b"]
    # the zombie leader accepts a local write; its shipment dies at the fence
    zombie = requests(family, 99, 3)
    tw.feed("a", zombie)
    for t in (tw.jax, tw.port):
        deadline = time.monotonic() + WAIT_S
        while not t.engines["a"]._shipper.fenced:
            assert time.monotonic() < deadline, "the deposed leader's shipment was never fenced"
            time.sleep(0.01)
        assert t.engines["a"].health()["state"] == "DEGRADED"
    tw.check()
    # the new lineage serves writes and replicates them
    tw.feed("b", requests(family, 2, 12))
    tw.wait("c", "b")
    tw.check_states("b", "c")
    # the old leader heals, steps down and bootstraps into the new lineage
    tw.both(lambda t: t.store.heal("a"))
    tw.tick("a")
    assert tw.port.writable() == ["b"] and tw.port.nodes["a"]._following == "b"
    tw.wait("a", "b")
    tw.check_states()
    key, args = requests(family, 3, 1)[0]
    for t in (tw.jax, tw.port):
        with pytest.raises(t.p.repl.NotPrimaryError):
            t.engines["a"].submit(key, *args)
    port_b = engine_states(tw.port.engines["b"])
    port_a = engine_states(tw.port.engines["a"])
    for key in port_b:  # the rejoined 'a' converges to the leader's states
        assert_trees_match(port_a[key], port_b[key], key)
    for _ in range(3):  # renewals, heartbeats, suspicions cleared
        tw.advance(1.0)
        tw.tick()


@pytest.mark.parametrize("first", ["b", "c"])
def test_exactly_one_survivor_wins_every_interleaving_in_both(twins, first):
    tw = twins("sum")
    tw.tick()
    tw.feed("a", requests("sum", 4, 10))
    tw.wait("b", "a")
    tw.wait("c", "a")
    tw.advance(1.0)
    tw.tick()  # member records reflect the caught-up followers
    tw.both(lambda t: t.store.partition("a"))
    tw.advance(3.5)
    second = "c" if first == "b" else "b"
    for name in (first, second, first, second, first, second):
        tw.tick(name)
        assert len([n for n in ("b", "c") if not tw.port.engines[n]._repl_follower]) <= 1
    winner = tw.port.store.read_lease().holder
    assert winner == "b" and tw.port.engines[winner]._repl_epoch == tw.port.store.read_lease().epoch
    tw.wait("c" if winner == "b" else "b", winner)
    tw.check_states("b", "c")


def test_a_partitioned_leader_steps_down_to_read_only_in_both(twins):
    tw = twins("sum")
    tw.tick()
    tw.feed("a", requests("sum", 5, 3))
    tw.wait("b", "a")
    tw.both(lambda t: t.store.partition("a"))
    tw.advance(1.0)
    tw.tick("a")  # covered until its own deadline
    tw.advance(3.0)
    tw.tick("a")
    assert tw.port.nodes["a"].role == "follower" and tw.port.engines["a"]._repl_follower
    assert tw.port.engines["a"].health()["cluster"]["lease_epoch"] is None


def test_not_promotable_backs_off_then_promotes_in_both(tmp_path):
    """The lease lands before the bootstrap snapshot: promote() refuses, the node
    keeps the lease and backs off (the same jittered instant in both), then
    promotes once the snapshot has landed."""
    rigs = {}
    for pkg in ("jax", "port"):
        p = PKG[pkg]
        clock = p.cluster.ManualClock(0.0)
        store = p.cluster.FakeCoordStore(clock=clock)
        links = {}

        def link(src, dst, links=links, p=p):
            return links.setdefault((src, dst), p.repl.LoopbackLink())

        follower = p.engine.StreamingEngine(make_metric("sum", pkg), replication=p.engine.ReplConfig(
            role="follower", transport=link("a", "b"), poll_interval_s=0.01,
            promote_checkpoint=p.engine.CheckpointConfig(directory=str(tmp_path / pkg / "b"))))
        node = p.cluster.ClusterNode(follower, p.cluster.ClusterConfig(
            node_id="b", peers=("a",), store=store, link_factory=link, rng_seed=11), start=False)
        rigs[pkg] = SimpleNamespace(p=p, clock=clock, store=store, link=link, follower=follower, node=node,
                                    primary=None)
    try:
        for r in rigs.values():
            r.store.acquire_lease("b", 100.0)
            r.node.tick()
        j, t = rigs["jax"], rigs["port"]
        assert type(t.node.last_error).__name__ == type(j.node.last_error).__name__ == "NotPromotableError"
        assert t.node._next_attempt == j.node._next_attempt > t.clock()
        assert t.node.role == j.node.role == "follower" and t.node._lease is not None
        for pkg, r in rigs.items():
            r.primary = r.p.engine.StreamingEngine(
                make_metric("sum", pkg),
                checkpoint=r.p.engine.CheckpointConfig(directory=str(tmp_path / pkg / "a"), wal_flush="fsync"),
                replication=r.p.engine.ReplConfig(role="primary", transport=r.link("a", "b"), ship_interval_s=0.01))
            r.primary.submit("k", np.array([7.0], np.float32))
            r.primary.flush()
            assert r.follower._applier.await_seq(r.primary._wal_seq, timeout_s=WAIT_S)
            r.clock.advance(5.0)
            r.node.tick()
        assert t.node.role == j.node.role == "leader" and t.node.failovers == j.node.failovers == 1
        assert t.follower._repl_epoch == j.follower._repl_epoch == 1
        assert float(t.follower.compute("k")) == float(j.follower.compute("k")) == 7.0
    finally:
        for r in rigs.values():
            r.node.close(release=False)
            r.follower.close()
            if r.primary is not None:
                r.primary.close()


def test_a_second_supervisor_is_refused_and_close_unhooks(tmp_path):
    engine = teng.StreamingEngine(tm.SumMetric(device="cpu"))
    try:
        assert engine._cluster is None and "cluster" not in engine.health()
        store = tc.FakeCoordStore(clock=tc.ManualClock(0.0))
        node = tc.ClusterNode(engine, tc.ClusterConfig(node_id="a", store=store, rng_seed=1), start=False)
        with pytest.raises(tc.ClusterConfigError, match="already supervised"):
            tc.ClusterNode(engine, tc.ClusterConfig(node_id="b", store=store, rng_seed=1), start=False)
        node.tick()
        assert engine.health()["cluster"]["role"] == "leader"
        node.close()
        assert engine._cluster is None and store.read_lease().expired(store.now())
    finally:
        engine.close()


def test_a_live_tick_thread_elects_and_stops(tmp_path):
    engine = teng.StreamingEngine(tm.SumMetric(device="cpu"))
    node = tc.ClusterNode(engine, tc.ClusterConfig(node_id="solo", store=tc.FakeCoordStore(), tick_interval_s=0.01,
                                                   rng_seed=2))
    try:
        deadline = time.monotonic() + WAIT_S
        while node.role != "leader" or node._lease is None:
            assert time.monotonic() < deadline, "the tick thread never took the lease"
            time.sleep(0.01)
    finally:
        node.close()
        engine.close()
    assert not node._thread.is_alive()


# --------------------------------------------------------------------------- the config


@pytest.mark.parametrize("kw,match", [
    ({"node_id": ""}, "non-empty"),
    ({"peers": ("a",)}, "must not include"),
    ({"peers": ("b", "b")}, "duplicate"),
    ({"lease_ttl_s": 0.0}, "lease_ttl_s"),
    ({"suspect_after_s": 7.0}, "must not exceed"),
    ({"peer_ranks": {"zz": 1}}, "unknown peers"),
    ({"comm_view": "view"}, "requires peer_ranks"),
])
def test_config_refusals_match_jax(kw, match):
    errors = []
    for p in (PKG["jax"], PKG["port"]):
        args = {"node_id": "a", "store": p.cluster.FakeCoordStore(clock=p.cluster.ManualClock(0.0)), **kw}
        with pytest.raises(p.cluster.ClusterConfigError, match=match) as info:
            p.cluster.ClusterConfig(**args)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


# --------------------------------------------------------------------------- the detector, on stub engines


class StubEngine:
    """The engine surface ClusterNode reads (the JAX detector tests' stub)."""

    def __init__(self):
        self._cluster = None
        self._repl_follower = False
        self._applier = None
        self._repl_cfg = None
        self._repl_epoch = 0

    def health(self):
        out = {"state": "SERVING"}
        if self._cluster is not None:
            out["cluster"] = self._cluster.health_view()
        return out


def _detector_trace(pkg, seed):
    p = PKG[pkg]
    rng = np.random.default_rng(seed)
    clock = p.cluster.ManualClock(0.0)
    store = p.cluster.FakeCoordStore(clock=clock)
    view = p.comm.WorldView(3, rank=0)
    node = p.cluster.ClusterNode(StubEngine(), p.cluster.ClusterConfig(
        node_id="a", store=store, peers=("b", "c"), comm_view=view, peer_ranks={"a": 0, "b": 1, "c": 2},
        rng_seed=7), start=False)
    trace = []
    for _ in range(80):
        r = rng.random()
        if r < 0.3:
            clock.advance(float(rng.choice([0.3, 1.0, 2.0, 3.0])))
        elif r < 0.5:
            peer = str(rng.choice(["b", "c"]))
            store.heartbeat(p.cluster.Member(peer, "follower", "SERVING", True, 0, clock()))
        elif r < 0.6:
            view.mark_lost([int(rng.integers(1, 3))])
        elif r < 0.65:
            view.commit([0, 1, 2])
        elif r < 0.72:
            getattr(store, str(rng.choice(["partition", "heal"])))("a")
        node.tick()
        trace.append((node.health_view(), node.suspicions, node.lease_renewals,
                      type(node.last_error).__name__ if node.last_error is not None else None))
    return trace


@pytest.mark.parametrize("seed", range(6))
def test_detector_script_gives_the_same_health_trace(seed):
    assert _detector_trace("port", seed) == _detector_trace("jax", seed)


def _series_total(text, name):
    return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines() if ln.startswith(name))


def test_the_cluster_series_count_like_jax():
    from metrics_tpu import obs as jobs

    obs.reset()
    jobs.reset()
    obs.enable()
    jobs.enable()
    try:
        _detector_trace("port", 3)
        _detector_trace("jax", 3)
        mine, ref = obs.REGISTRY.render_prometheus(), jobs.REGISTRY.render_prometheus()
        for suffix in ("suspicions_total", "lease_renewals_total", "failovers_total"):
            assert _series_total(mine, f"metrics_tpu_torch_cluster_{suffix}") == \
                _series_total(ref, f"metrics_tpu_cluster_{suffix}"), suffix
        assert _series_total(mine, "metrics_tpu_torch_cluster_suspicions_total") > 0
        assert 'metrics_tpu_torch_cluster_role{node="a"}' in mine
    finally:
        obs.disable()
        jobs.disable()
        obs.reset()
        jobs.reset()


def test_a_lost_election_dumps_an_election_failed_bundle(tmp_path):
    from metrics_tpu_torch.obs.flight import FLIGHT

    obs.reset()
    obs.enable()
    FLIGHT.clear()
    try:
        clock = tc.ManualClock(0.0)
        store = tc.FakeCoordStore(clock=clock)
        eng = StubEngine()
        eng._repl_follower = True
        eng._applier = SimpleNamespace(epoch=0, bootstrapped=True, _gap=False,
                                       lag=lambda: SimpleNamespace(seqs_behind=0))
        node = tc.ClusterNode(eng, tc.ClusterConfig(node_id="b", store=store, peers=("a",), rng_seed=1),
                              start=False)
        real = store.acquire_lease
        store.acquire_lease = lambda *a, **k: (real("a", 3.0), None)[1]  # another candidate wins the CAS
        node.tick()
        assert node.role == "follower"
        assert FLIGHT.dump_counts().get("election_failed") == 1
        assert FLIGHT.bundles()[-1]["trigger"] == "election_failed"
    finally:
        FLIGHT.clear()
        obs.disable()
        obs.reset()


# --------------------------------------------------------------------------- the client router


class StubNode:
    def __init__(self, name, log):
        self.name, self.log = name, log
        self.submit_exc = self.compute_exc = None

    def submit(self, key, *args, **kwargs):
        self.log.append(("submit", self.name))
        if self.submit_exc is not None:
            raise self.submit_exc
        return f"submit@{self.name}"

    def compute(self, key, **kwargs):
        self.log.append(("compute", self.name))
        if self.compute_exc is not None:
            raise self.compute_exc
        return f"compute@{self.name}"


def _client_script(pkg, seed):
    """A seeded script of failovers, refusals and routed calls; returns what the
    router did (targets, results, redirects, backoff sleeps)."""
    p = PKG[pkg]
    rng = np.random.default_rng(seed)
    clock = p.cluster.ManualClock(0.0)
    store = p.cluster.FakeCoordStore(clock=clock)
    log, sleeps = [], []
    engines = {n: StubNode(n, log) for n in NODES}
    store.acquire_lease("a", 5.0)
    client = p.cluster.ClusterClient(store, engines, sleep=sleeps.append, rng_seed=seed, retries=4)
    errors = {"not_primary": p.repl.NotPrimaryError, "stale": p.repl.StalenessExceeded,
              "closed": p.engine.EngineClosed}
    out = []
    for _ in range(60):
        r = rng.random()
        if r < 0.15:
            clock.advance(float(rng.choice([0.1, 1.0, 6.0])))
        elif r < 0.25:
            holder = str(rng.choice(NODES))
            lease = store.read_lease()
            if lease is not None:
                store.release_lease(lease.holder)
            store.acquire_lease(holder, 5.0)
        elif r < 0.4:
            node = engines[str(rng.choice(NODES))]
            kind = str(rng.choice(["none", "not_primary", "stale", "closed"]))
            exc = None if kind == "none" else errors[kind]("refused")
            if rng.random() < 0.5:
                node.submit_exc = exc if kind != "stale" else None
            else:
                node.compute_exc = exc
        else:
            op = str(rng.choice(["submit", "compute", "compute_replica", "call"]))
            try:
                if op == "submit":
                    res = client.submit("k", 1)
                elif op == "call":
                    res = client.call("compute", "k", prefer="replica", retries=1)
                else:
                    res = client.compute("k", prefer="replica" if op == "compute_replica" else "leader")
                out.append((op, res))
            except Exception as exc:  # noqa: BLE001 — the refusal itself is compared
                out.append((op, type(exc).__name__, str(exc)))
    return out, log, sleeps, client.redirects, client.leader_id()


@pytest.mark.parametrize("seed", range(6))
def test_client_takes_the_same_redirects_and_backoff_sequence(seed):
    got, want = _client_script("port", seed), _client_script("jax", seed)
    assert got == want and got[0]
