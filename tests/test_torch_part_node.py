"""The port's partition plane (``PartitionMap``, ``PartitionedNode``,
``PartitionedClient``) against the JAX package's, on the CPU.

``partition_of`` agrees across the packages for 10^4 keys of every key type of
``stable_key_bytes``, with and without migration overrides, and a
``partition_manifest.json`` written by either package loads in the other.
Per-partition elections over stub engines (the JAX election tests' stubs)
take the same leases, roles and backoffs under one ``ManualClock`` script. A
``PartCluster`` twin of real engines in each package (3 nodes x 4 partitions,
``tests/part/conftest.py``) forms, loses a host leading two partitions, fails
both over independently, fences the zombie per partition and takes the host
back, with the same trace after every tick and equal states once the
followers have caught up. ``PartitionedClient`` takes the same routes,
redirects and backoff sleeps. Every wait has a deadline that fails the test.
"""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest

import metrics_tpu as jm
import metrics_tpu.cluster as jc
import metrics_tpu.engine as jeng
import metrics_tpu.part as jp
import metrics_tpu.repl as jrepl
import metrics_tpu_torch as tm
import metrics_tpu_torch.cluster as tc
import metrics_tpu_torch.engine as teng
import metrics_tpu_torch.part as tp
import metrics_tpu_torch.repl as trepl
from tests.test_torch_engine import _one_torch_thread, assert_trees_match, engine_states  # noqa: F401
from tests.test_torch_shard_ring import _keys

WAIT_S = 20
NODES = ("a", "b", "c")
P = 4
PKG = {
    "jax": SimpleNamespace(top=jm, cluster=jc, engine=jeng, repl=jrepl, part=jp, cpu={}),
    "port": SimpleNamespace(top=tm, cluster=tc, engine=teng, repl=trepl, part=tp, cpu={"device": "cpu"}),
}


# --------------------------------------------------------------------------- the map


@pytest.mark.parametrize("partitions,vnodes,seed", [(8, 256, 0), (3, 16, 7), (16, 64, 1)])
def test_partition_of_equals_jax_for_every_key_type(partitions, vnodes, seed):
    keys = _keys(seed)
    mine = tp.PartitionMap(partitions, vnodes=vnodes, seed=seed)
    ref = jp.PartitionMap(partitions, vnodes=vnodes, seed=seed)
    rng = np.random.default_rng(seed)
    for key in keys[:: 97]:  # some keys moved by a migration
        pid = int(rng.integers(0, partitions))
        mine.set_override(key, pid)
        ref.set_override(key, pid)
    assert [mine.partition_of(k) for k in keys] == [ref.partition_of(k) for k in keys]
    assert mine._overrides == ref._overrides and mine.names() == ref.names()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_manifest_of_either_package_loads_in_the_other(tmp_path, writer):
    w, r = (jp, tp) if writer == "jax" else (tp, jp)
    made = w.PartitionMap(8, seed=3, directory=str(tmp_path))
    keys = [f"tenant-{i}" for i in range(40)] + [(1, "x"), 42, b"raw", 2.5, None, True]
    for i, key in enumerate(keys[::3]):
        made.set_override(key, (made.partition_of(key) + 1 + i) % 8)
    made.set_epoch_floor(2, 5)
    made.set_epoch_floor(2, 3)  # monotone: the floor stays at 5
    made.commit()
    loaded = r.PartitionMap(8, seed=3, directory=str(tmp_path))
    assert [loaded.partition_of(k) for k in keys] == [made.partition_of(k) for k in keys]
    assert loaded.epoch_floor(2) == 5 and loaded.epoch_floor(0) == 0
    doc = json.loads((tmp_path / "partition_manifest.json").read_text())
    assert set(doc) == {"partitions", "vnodes", "seed", "overrides", "epoch_floors"}
    errors = []
    for pkg in (jp, tp):
        with pytest.raises(Exception, match="strands tenants") as info:
            pkg.PartitionMap(8, seed=4, directory=str(tmp_path))
        errors.append((type(info.value).__name__, str(info.value)))
    assert errors[0] == errors[1]


def test_override_back_to_the_ring_is_dropped_and_names_range_checked():
    for pkg in (jp, tp):
        pm = pkg.PartitionMap(4, seed=1)
        key = "tenant-3"
        home = pm.partition_of(key)
        pm.set_override(key, (home + 1) % 4)
        pm.set_override(key, home)
        assert pm._overrides == {} and pkg.partition_name(3) == "p3"
        with pytest.raises(Exception, match="out of range"):
            pm.set_override(key, 4)
        with pytest.raises(Exception, match="commit"):
            pm.commit()


# --------------------------------------------------------------------------- elections over stubs


class StubApplier:
    def __init__(self, lag):
        self.epoch, self.bootstrapped, self._gap, self.applied_seq, self._lag = 0, True, False, 0, lag

    def lag(self):
        return SimpleNamespace(seqs_behind=self._lag)


class StubEngine:
    """The engine surface PartitionedNode supervises (the JAX election tests')."""

    def __init__(self, writable, lag, not_promotable):
        self._repl_follower = not writable
        self._repl_cfg = None
        self._repl_epoch = 0
        self._cluster = None
        self._applier = None if writable else StubApplier(lag)
        self.promote_raises = list(not_promotable)
        self.telemetry = None

    def health(self):
        return {"state": "SERVING"}

    def promote(self, *, epoch=None, ship=None):
        if self.promote_raises:
            raise self.promote_raises.pop(0)
        self._repl_follower, self._repl_epoch, self._applier = False, epoch, None

    def demote(self, replication=None):
        self._repl_follower = True


def _election_trace(pkg, seed):
    p = PKG[pkg]
    rng = np.random.default_rng(seed)
    clock = p.cluster.ManualClock(0.0)
    store = p.cluster.FakeCoordStore(clock=clock)
    pmap = p.part.PartitionMap(P, seed=seed)
    not_promotable = p.repl.NotPromotableError
    nodes = {}
    for i, name in enumerate(NODES):
        engines = {pid: StubEngine(writable=(pid % 3 == i and pid < 3), lag=int(rng.integers(0, 3)),
                                   not_promotable=[not_promotable("snapshot pending")] * int(rng.integers(0, 2)))
                   for pid in range(P)}
        nodes[name] = p.part.PartitionedNode(engines, p.part.PartConfig(
            node_id=name, peers=tuple(n for n in NODES if n != name), store=store, partitions=P,
            election_backoff_s=0.25, rng_seed=seed + i), pmap=pmap, start=False)
    trace = []
    for _ in range(70):
        r = rng.random()
        if r < 0.3:
            clock.advance(float(rng.choice([0.2, 1.0, 2.0, 3.5])))
        elif r < 0.38:
            getattr(store, str(rng.choice(["partition", "heal"])))(str(rng.choice(NODES)))
        name = str(rng.choice(NODES))
        nodes[name].tick()
        trace.append((name, nodes[name].health_view(), nodes[name].owned(),
                      type(nodes[name].last_error).__name__ if nodes[name].last_error is not None else None,
                      [(s.next_attempt, s.promote_backoff, s.election_backoff) for s in nodes[name]._slots.values()]))
    return trace


@pytest.mark.parametrize("seed", range(6))
def test_per_partition_elections_take_the_same_trace(seed):
    assert _election_trace("port", seed) == _election_trace("jax", seed)


# --------------------------------------------------------------------------- real engines


def home_of(pid):
    return NODES[pid % len(NODES)]


class PartCluster:
    """Three PartitionedNodes of one package over P = 4 partitions of real
    engines (``SumMetric``), formation deterministic (the home holds each
    lease before the first tick)."""

    def __init__(self, pkg, root):
        p = self.p = PKG[pkg]
        self.clock = p.cluster.ManualClock(0.0)
        self.store = p.cluster.FakeCoordStore(clock=self.clock)
        self.pmap = p.part.PartitionMap(P, seed=7)
        self._links = {}
        self.engines = {n: {} for n in NODES}
        self.nodes = {}
        for pid in range(P):
            pname, leader = p.part.partition_name(pid), home_of(pid)
            followers = tuple(n for n in NODES if n != leader)
            self.engines[leader][pid] = p.engine.StreamingEngine(
                p.top.SumMetric(**p.cpu), buckets=(8,),
                checkpoint=p.engine.CheckpointConfig(directory=str(root / leader / pname), interval_s=0.05,
                                                     wal_flush="fsync"),
                replication=p.engine.ReplConfig(
                    role="primary", transport=p.repl.FanoutTransport([self.link(leader, f, pname) for f in followers]),
                    ship_interval_s=0.01, heartbeat_interval_s=0.05, epoch=1))
            for name in followers:
                self.engines[name][pid] = p.engine.StreamingEngine(
                    p.top.SumMetric(**p.cpu), buckets=(8,),
                    replication=p.engine.ReplConfig(
                        role="follower", transport=self.link(leader, name, pname), poll_interval_s=0.01,
                        promote_checkpoint=p.engine.CheckpointConfig(directory=str(root / name / pname),
                                                                     interval_s=0.05, wal_flush="fsync")))
            assert self.store.acquire_lease(leader, 3.0, name=pname) is not None
        for name in NODES:
            self.nodes[name] = p.part.PartitionedNode(self.engines[name], p.part.PartConfig(
                node_id=name, peers=tuple(n for n in NODES if n != name), store=self.store, partitions=P,
                link_factory=self.link, seed=7, lease_ttl_s=3.0, heartbeat_interval_s=1.0, suspect_after_s=2.5,
                confirm_after_s=6.0, election_backoff_s=0.25, rng_seed=ord(name)), pmap=self.pmap, start=False)

    def link(self, src, dst, partition):
        return self._links.setdefault((src, dst, partition), self.p.repl.LoopbackLink())

    def feed(self, node, pid, values):
        for v in values:
            self.engines[node][pid].submit(f"k{pid}", np.array([float(v)], np.float32))
        self.engines[node][pid].flush()

    def wait_caught_up(self, follower, leader, pid):
        target = self.engines[leader][pid]._wal_seq
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            applier = self.engines[follower][pid]._applier
            if applier is not None and applier.bootstrapped and applier.applied_seq >= target:
                return
            time.sleep(0.01)
        raise AssertionError(f"{follower}/p{pid} never caught up to {leader}'s seq {target}")

    def observe(self):
        now = self.store.now()
        leases = {}
        for pid in range(P):
            lease = self.store.read_lease(self.p.part.partition_name(pid))
            leases[pid] = None if lease is None else (lease.holder, lease.epoch, lease.deadline, lease.expired(now))
        return {
            "leases": leases,
            "writable": {pid: [n for n in NODES if not self.engines[n][pid]._repl_follower] for pid in range(P)},
            **{name: {"health_view": node.health_view(), "owned": node.owned(),
                      "following": {pid: s.following for pid, s in node._slots.items()},
                      "engine_cluster": [self.engines[name][pid].health()["cluster"] for pid in range(P)],
                      "labels": [self.engines[name][pid].telemetry.label("partition") for pid in range(P)]}
               for name, node in self.nodes.items()},
        }

    def close(self):
        for node in self.nodes.values():
            node.close(release=False)
        for per_pid in self.engines.values():
            for engine in per_pid.values():
                engine.close()


class Twins:
    def __init__(self, root):
        self.jax, self.port = PartCluster("jax", root / "jax"), PartCluster("port", root / "port")

    def both(self, fn):
        return fn(self.jax), fn(self.port)

    def tick(self, *names):
        for name in names or NODES:
            self.both(lambda t: t.nodes[name].tick())
            got, want = self.port.observe(), self.jax.observe()
            assert got == want, (got, want)

    def wait(self, pid, leader):
        for name in NODES:
            if name != leader:
                self.both(lambda t: t.wait_caught_up(name, leader, pid))

    def check_states(self):
        for name in NODES:
            for pid in range(P):
                j = engine_states(self.jax.engines[name][pid])
                p = engine_states(self.port.engines[name][pid])
                assert set(p) == set(j), (name, pid)
                for key in j:
                    assert_trees_match(p[key], j[key], f"{name}/p{pid}/{key}")


@pytest.fixture
def twins(tmp_path):
    tw = Twins(tmp_path)
    yield tw
    tw.both(lambda t: t.close())


def test_a_dead_host_fails_its_partitions_over_independently_in_both(twins):
    tw = twins
    tw.tick()
    assert tw.port.nodes["a"].owned() == (0, 3) and tw.port.nodes["b"].owned() == (1,)
    for pid in range(P):
        tw.both(lambda t: t.feed(home_of(pid), pid, range(5 + pid)))
        tw.wait(pid, home_of(pid))
    tw.check_states()
    for _ in range(2):  # member records refreshed; every lease renewed at half its TTL
        tw.both(lambda t: t.clock.advance(1.0))
        tw.tick()
    epochs = {pid: tw.port.store.read_lease(f"p{pid}").epoch for pid in range(P)}
    tw.both(lambda t: t.store.partition("a"))  # 'a' dies holding p0 and p3
    for _ in range(4):  # the survivors keep renewing p1 and p2 while a's leases run out
        tw.both(lambda t: t.clock.advance(1.0))
        for name in ("b", "c"):
            tw.tick(name)
            for pid in range(P):
                assert len([n for n in ("b", "c") if not tw.port.engines[n][pid]._repl_follower]) <= 1
    leaders = {pid: tw.port.store.read_lease(f"p{pid}").holder for pid in range(P)}
    assert leaders[1] == "b" and leaders[2] == "c" and leaders[0] in ("b", "c") and leaders[3] in ("b", "c")
    for pid in (0, 3):
        assert tw.port.store.read_lease(f"p{pid}").epoch > epochs[pid]
    for pid in (1, 2):
        assert tw.port.store.read_lease(f"p{pid}").epoch == epochs[pid]
    # a zombie write on p0 dies at p0's fence; 'a' keeps p3's engine writable until it ticks
    tw.both(lambda t: t.feed("a", 0, [999.0]))
    for t in (tw.jax, tw.port):
        deadline = time.monotonic() + WAIT_S
        while not t.engines["a"][0]._shipper.fenced:
            assert time.monotonic() < deadline, "p0's zombie shipment was never fenced"
            time.sleep(0.01)
    for pid in (0, 3):
        tw.both(lambda t: t.feed(leaders[pid], pid, [1.0, 2.0]))
    tw.both(lambda t: t.store.heal("a"))
    tw.tick("a")
    assert tw.port.nodes["a"].owned() == ()
    for pid in range(P):
        tw.wait(pid, leaders[pid])
    tw.check_states()
    for pid in range(P):  # every replica of a partition holds the same sum
        sums = {float(tw.port.engines[n][pid].compute(f"k{pid}")) for n in NODES}
        assert len(sums) == 1, (pid, sums)


def test_partition_labels_and_engine_refusal(twins):
    tw = twins
    assert [tw.port.engines["a"][pid].telemetry.label("partition") for pid in range(P)] == ["p0", "p1", "p2", "p3"]
    with pytest.raises(tc.ClusterConfigError, match="already supervised"):
        tp.PartitionedNode(tw.port.engines["a"], tp.PartConfig(node_id="z", store=tw.port.store, partitions=P),
                           start=False)
    with pytest.raises(tc.ClusterConfigError, match="cover exactly"):
        tp.PartitionedNode({0: tw.port.engines["a"][0]}, tp.PartConfig(node_id="z", store=tw.port.store,
                                                                       partitions=2), start=False)


@pytest.mark.parametrize("kw,match", [
    ({"node_id": ""}, "non-empty"),
    ({"partitions": 0}, "partitions must be"),
    ({"peers": ("a",)}, "must not include"),
    ({"peers": ("b", "b")}, "duplicate"),
    ({"lease_ttl_s": -1.0}, "lease_ttl_s"),
    ({"suspect_after_s": 9.0}, "must not exceed"),
])
def test_part_config_refusals_match_jax(kw, match):
    errors = []
    for p in (PKG["jax"], PKG["port"]):
        with pytest.raises(p.cluster.ClusterConfigError, match=match) as info:
            p.part.PartConfig(**{"node_id": "a", "store": p.cluster.FakeCoordStore(), **kw})
        errors.append(str(info.value))
    assert errors[0] == errors[1]


# --------------------------------------------------------------------------- the client


class StubNode:
    def __init__(self, name, pid, log):
        self.name, self.pid, self.log = name, pid, log
        self.exc = None

    def submit(self, key, *args, **kwargs):
        self.log.append(("submit", self.name, self.pid, key))
        if self.exc is not None:
            raise self.exc
        return f"{self.name}/p{self.pid}"

    def compute(self, key, **kwargs):
        self.log.append(("compute", self.name, self.pid, key))
        if self.exc is not None:
            raise self.exc
        return f"{self.name}/p{self.pid}"


def _client_script(pkg, seed):
    p = PKG[pkg]
    rng = np.random.default_rng(seed)
    clock = p.cluster.ManualClock(0.0)
    store = p.cluster.FakeCoordStore(clock=clock)
    pmap = p.part.PartitionMap(P, seed=seed)
    log, sleeps = [], []
    engines = {n: {pid: StubNode(n, pid, log) for pid in range(P)} for n in NODES}
    for pid in range(P):
        store.acquire_lease(home_of(pid), 5.0, name=p.part.partition_name(pid))
    client = p.part.PartitionedClient(store, engines, pmap=pmap, retries=3, sleep=sleeps.append, rng_seed=seed)
    refusals = [p.repl.NotPrimaryError, p.repl.StalenessExceeded, p.engine.EngineClosed]
    out = []
    for _ in range(60):
        r = rng.random()
        pid = int(rng.integers(0, P))
        if r < 0.15:
            clock.advance(float(rng.choice([0.5, 2.0, 6.0])))
        elif r < 0.25:
            name = p.part.partition_name(pid)
            lease = store.read_lease(name)
            if lease is not None:
                store.release_lease(lease.holder, name=name)
            store.acquire_lease(str(rng.choice(NODES)), 5.0, name=name)
        elif r < 0.35:
            node = engines[str(rng.choice(NODES))][pid]
            node.exc = None if rng.random() < 0.4 else refusals[int(rng.integers(0, 3))]("refused")
        else:
            key = f"tenant-{int(rng.integers(0, 30))}"
            op = str(rng.choice(["submit", "compute", "replica"]))
            try:
                res = client.submit(key, 1) if op == "submit" else \
                    client.compute(key, prefer="replica" if op == "replica" else "leader")
                out.append((op, key, res))
            except Exception as exc:  # noqa: BLE001 — the refusal itself is compared
                out.append((op, key, type(exc).__name__))
    return out, log, sleeps, client.redirects, client.routing_table()


@pytest.mark.parametrize("seed", range(4))
def test_partitioned_client_takes_the_same_routes_and_backoffs(seed):
    got, want = _client_script("port", seed), _client_script("jax", seed)
    assert got == want and got[0]
