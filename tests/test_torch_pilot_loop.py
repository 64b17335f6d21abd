"""The port's autopilot at work (``Actuator``, ``AutoPilot``) over a port
``PartitionedNode`` against the JAX package's, on the CPU.

A ``PilotRig`` of each package (the JAX pilot tests' rig: one host leading 4
partitions of ``SumMetric`` engines under a ``ManualClock``'d
``FakeCoordStore``, a ``FleetAggregator`` on the same clock) is driven by one
script with ``start=False`` and manual ``tick()``s. The actuator's budget,
cooldown, ``dry_run``, ``not_local``, error, retune and resize outcomes are
equal; the pilots reach the JAX rig's holder / standby, pause, dry-run,
storm-rebalance and failover outcomes, with equal journals (the decisions and
outcomes record for record; the observed p99s come from each process's own
latency ring and are left out) and the moved tenants' states equal. A tier
retune takes effect at the engine's next sweep, and a slab grown after it
keeps every state. The signals come from crafted snapshots as in the JAX
tests, and, in the last tests, from the port's own engine telemetry: a
``SignalBook`` sees a port engine's partition rate under the port's family
names, and an ``AutoPilot`` spreads a hot partition it observes only through
its own registry.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest

import metrics_tpu as jm
import metrics_tpu.cluster as jc
import metrics_tpu.engine as jeng
import metrics_tpu.obs.fleet as jfleet
import metrics_tpu.part as jp
import metrics_tpu.pilot as jpilot
import metrics_tpu.tier as jtier
import metrics_tpu_torch as tm
import metrics_tpu_torch.cluster as tc
import metrics_tpu_torch.engine as teng
import metrics_tpu_torch.obs as tobs
import metrics_tpu_torch.obs.fleet as tfleet
import metrics_tpu_torch.part as tp
import metrics_tpu_torch.pilot as tpilot
import metrics_tpu_torch.pilot.signals as tsignals
import metrics_tpu_torch.tier as ttier
from tests.test_torch_engine import _one_torch_thread  # noqa: F401
from tests.test_torch_pilot_plan import make_snapshot

P = 4
PKG = {
    "jax": SimpleNamespace(top=jm, cluster=jc, engine=jeng, fleet=jfleet, part=jp, pilot=jpilot, tier=jtier, cpu={}),
    "port": SimpleNamespace(top=tm, cluster=tc, engine=teng, fleet=tfleet, part=tp, pilot=tpilot, tier=ttier,
                            cpu={"device": "cpu"}),
}


class PilotRig:
    """One host leading all P partitions, plus the pilot's clockwork, of one package."""

    def __init__(self, pkg, node_id="a", tier=None, capacity=8):
        p = self.p = PKG[pkg]
        self.pkg = pkg
        self.clock = p.cluster.ManualClock(0.0)
        self.store = p.cluster.FakeCoordStore(clock=self.clock)
        self.aggregator = p.fleet.FleetAggregator(stale_after_s=10.0, retire_after_s=600.0, clock=self.clock)
        self.engines = {
            pid: p.engine.StreamingEngine(p.top.SumMetric(**p.cpu), buckets=(8,), capacity=capacity,
                                          tier=p.tier.TierConfig(**tier) if tier and pid == 0 else None)
            for pid in range(P)
        }
        self.node = p.part.PartitionedNode(
            self.engines,
            p.part.PartConfig(node_id=node_id, peers=(), store=self.store, partitions=P, seed=7, lease_ttl_s=30.0,
                              heartbeat_interval_s=1.0, rng_seed=1),
            start=False,
        )
        for _ in range(12):  # election backoff gates candidacy per partition
            self.node.tick()
            if len(self.node.owned()) == P:
                break
            self.clock.advance(0.5)
        assert self.node.owned() == tuple(range(P))

    def keys_on(self, pid, n, prefix="tenant"):
        out = [k for i in range(5000) if self.node.pmap.partition_of(k := f"{prefix}-{i}") == pid][:n]
        assert len(out) == n
        return out

    def feed(self, pid, keys, reps=1):
        for key in keys:
            for r in range(reps):
                self.engines[pid].submit(key, np.asarray([1.0 + r], np.float32))
        self.engines[pid].flush()

    def pilot(self, node_id="a", **kw):
        kw.setdefault("ewma_alpha", 1.0)
        kw.setdefault("evaluate_interval_s", 1.0)
        kw.setdefault("lease_ttl_s", 3.0)
        kw.setdefault("migration_budget", 8)
        cfg = self.p.pilot.PilotConfig(node_id=node_id, store=self.store, **kw)
        return self.p.pilot.AutoPilot(self.node, cfg, aggregator=self.aggregator, start=False)

    def actuator(self, sharded=None, **kw):
        return self.p.pilot.Actuator(self.p.pilot.PilotConfig(node_id="a", store=self.store, **kw), self.node,
                                     sharded=sharded)

    def storm(self, pilot, t0=1000.0, hot="p0", cycles=3, rate=600.0):
        """Worker snapshots in which one partition runs hot, one pilot tick each."""
        quiet = {q: 10.0 for q in ("p0", "p1", "p2", "p3")}
        for i in range(cycles):
            submitted = {q: i * v for q, v in quiet.items()}
            submitted[hot] = i * rate
            self.aggregator.ingest(make_snapshot(self.pkg, "worker", t0 + i, submitted=submitted,
                                                 depth={q: 0.0 for q in quiet}))
            pilot.tick()
            self.clock.advance(1.5)

    def value(self, key):
        return float(np.asarray(self.engines[self.node.pmap.partition_of(key)].compute(key)))

    def close(self):
        self.node.close(release=False)
        for eng in self.engines.values():
            eng.close()
            eng.telemetry.retire()  # a later rig's partitions start from fresh series


@pytest.fixture
def rigs():
    made = {pkg: PilotRig(pkg) for pkg in PKG}
    yield made
    for r in made.values():
        r.close()


def both(rigs, fn):
    """``fn(rig)`` in each package; the results, port first."""
    return fn(rigs["port"]), fn(rigs["jax"])


def _strip(records):
    """Journal records without the p99s each process reads off its own latency ring."""
    out = []
    for r in records:
        r = dict(r, observations=dict(r["observations"]))
        r["observations"]["partitions"] = {p: {k: v for k, v in d.items() if k != "p99_s"}
                                           for p, d in r["observations"]["partitions"].items()}
        out.append(r)
    return out


# --------------------------------------------------------------------------- the actuator


def test_the_budget_window_refuses_then_slides_open(rigs):
    def run(rig):
        act = rig.actuator(migration_budget=2, budget_window_s=10.0)
        keys = rig.keys_on(0, 3)
        rig.feed(0, keys)
        first = act.execute([rig.p.pilot.MigrateTenant(k, 0, 1) for k in keys], now=100.0)
        left = (act.budget_left(100.0), act.budget_left(111.0))
        second = act.execute([rig.p.pilot.MigrateTenant(keys[2], 0, 1)], now=111.0)
        return first, left, second, (act.executed, act.refused, act.failures), [rig.value(k) for k in keys]

    port, ref = both(rigs, run)
    assert port == ref
    assert [o["outcome"] for o in port[0]] == ["ok", "ok", "refused_budget"] and port[1] == (0, 2)


def test_a_cooling_tenant_is_refused_until_its_cooldown_ends(rigs):
    def run(rig):
        act = rig.actuator(tenant_cooldown_s=30.0)
        (key,) = rig.keys_on(0, 1)
        rig.feed(0, [key], reps=3)
        out = [act.execute([rig.p.pilot.MigrateTenant(key, s, d)], now=t)[0]
               for t, s, d in ((0.0, 0, 1), (5.0, 1, 2), (31.0, 1, 2))]
        return out, rig.node.pmap.partition_of(key), rig.value(key)

    port, ref = both(rigs, run)
    assert port == ref
    assert [o["outcome"] for o in port[0]] == ["ok", "refused_cooldown", "ok"] and port[1:] == (2, 6.0)


def test_not_local_dry_run_and_an_unknown_tenant(rigs):
    def run(rig):
        out = []
        (key,) = rig.keys_on(0, 1)
        rig.feed(0, [key])
        act = rig.actuator()
        rig.engines[1]._repl_follower = True
        try:
            out.append(act.execute([rig.p.pilot.MigrateTenant(key, 0, 1)], now=0.0)[0])
            out.append(act.budget_left(0.0))
        finally:
            rig.engines[1]._repl_follower = False
        dry = rig.actuator(dry_run=True)
        out.append(dry.execute([rig.p.pilot.MigrateTenant(key, 0, 1)], now=0.0)[0])
        unknown = rig.keys_on(0, 1, prefix="never")[0]
        failed = act.execute([rig.p.pilot.MigrateTenant(unknown, 0, 1)], now=0.0)[0]
        out.append(failed)
        out.append((act.executed, act.refused, act.failures, act.budget_left(0.0)))
        out.append((dry.executed, rig.node.pmap.partition_of(key), key in rig.engines[0]._keyed.keys))
        return out

    port, ref = both(rigs, run)
    assert port == ref
    assert port[0]["outcome"] == "not_local" and port[2]["outcome"] == "dry_run" and port[2]["plan"]["valid"]
    assert port[3]["outcome"] == "error" and "unknown" in port[3]["error"]


def test_retune_and_resize_outcomes(rigs):
    class FakeSharded:
        _engines = [object(), object()]

        def resize(self, n):
            self.resized_to = n
            return {"k1": (0, 2), "k2": (1, 3)}

    def run(rig):
        p = rig.p.pilot
        out = [rig.actuator().execute([p.RetuneTier(pid=0, hot_capacity=64)], now=0.0)[0],
               rig.actuator().execute([p.ResizeShards(new_shards=8)], now=0.0)[0]]
        sharded = FakeSharded()
        out.append(rig.actuator(sharded=sharded).execute([p.ResizeShards(new_shards=4)], now=0.0)[0])
        out.append(rig.actuator(sharded=sharded, dry_run=True).execute([p.ResizeShards(4)], now=0.0)[0])
        out.append(sharded.resized_to)
        return out

    port, ref = both(rigs, run)
    assert port == ref
    assert [o["outcome"] for o in port[:4]] == ["no_tier", "no_sharded", "ok", "dry_run"]


def test_a_retune_takes_effect_at_the_next_sweep():
    """A tiered partition engine at hot capacity 2 on a 2-row slab, its tenants
    admitted one at a time: the retune to 8 replaces the frozen config, the
    next sweep keeps 6 tenants hot where it kept 2, the slab grows to hold
    them after the retune, and every state still equals the JAX twin's."""
    tier = {"hot_capacity": 2, "check_interval_s": 0.0, "idle_demote_s": 1e9}
    made = {pkg: PilotRig(pkg, tier=tier, capacity=2) for pkg in PKG}
    try:
        def run(rig):
            keys = rig.keys_on(0, 6)
            eng = rig.engines[0]
            for key in keys[:4]:
                rig.feed(0, [key], reps=2)
            eng._maybe_tier()
            hot, rows = [len(eng._keyed.keys)], [eng._keyed.capacity]
            out = rig.actuator().execute([rig.p.pilot.RetuneTier(pid=0, hot_capacity=8)], now=0.0)[0]
            assert eng._tier.cfg.hot_capacity == 8 and type(eng._tier.cfg).__name__ == "TierConfig"
            rig.feed(0, keys, reps=1)
            eng._maybe_tier()
            hot.append(len(eng._keyed.keys))
            rows.append(eng._keyed.capacity)
            return (out, hot, [rig.value(k) for k in keys]), rows

        (port, rows), (ref, _) = run(made["port"]), run(made["jax"])
        assert port == ref
        assert port[0]["outcome"] == "ok" and port[0]["was"] == 2 and port[1] == [2, 6]
        assert port[2] == [4.0, 4.0, 4.0, 4.0, 1.0, 1.0]
        assert rows[1] >= 6 > rows[0], rows  # grown after the retune, states kept
    finally:
        for r in made.values():
            r.close()


# --------------------------------------------------------------------------- the loop


def test_the_holder_cycles_and_the_standby_waits(rigs):
    def run(rig):
        a, b = rig.pilot("a"), rig.pilot("b")
        a.tick()
        b.tick()
        out = [a.role, b.role, a.cycles, b.cycles, a.health()["lease_epoch"], b.health()["lease_epoch"]]
        rig.clock.advance(2.0)
        a.tick()  # renews inside the evaluate interval: no cycle
        out += [a.cycles, a.role]
        a.close(release=True)  # a clean shutdown concedes
        b.tick()
        out += [b.role, b.cycles]
        health = {k: v for k, v in b.health().items() if k != "lease_ttl_remaining_s"}
        b.close(release=False)
        return out, health

    port, ref = both(rigs, run)
    assert port == ref
    assert port[0][:4] == ["pilot", "standby", 1, 0] and port[0][-2:] == ["pilot", 1]


def test_a_dead_holder_fails_over_within_one_ttl_and_the_journal_numbers_on(rigs, tmp_path):
    """The standby opened its journal before the holder wrote to it. The port's
    journal numbers on past the holder's records; the JAX package's repeats
    seq 0 (ROADMAP C.12, a fault of the reference not copied)."""
    def run(rig):
        journal = str(tmp_path / rig.pkg)
        a = rig.pilot("a", lease_ttl_s=3.0, journal_directory=journal)
        b = rig.pilot("b", lease_ttl_s=3.0, journal_directory=journal)
        a.tick()
        b.tick()
        roles = [(a.role, b.role)]
        rig.clock.advance(4.0)  # 'a' dies silently; its lease runs out
        b.tick()
        roles.append((a.role, b.role))
        a.close(release=False)
        b.close(release=False)
        return roles, [(r["seq"], r["node"], r["lease_epoch"]) for r in rig.p.pilot.read_journal(journal)]

    port, ref = both(rigs, run)
    assert port[0] == ref[0] == [("pilot", "standby"), ("standby", "pilot")]
    assert [(s, n) for s, n, _ in port[1]] == [(0, "a"), (1, "b")]
    assert [(s, n) for s, n, _ in ref[1]] == [(0, "a"), (0, "b")]
    assert [e for _, _, e in port[1]] == [e for _, _, e in ref[1]] == [1, 2]


def test_a_disabled_pilot_is_inert(rigs):
    def run(rig):
        a = rig.pilot("a", enabled=False)
        a.tick()
        b = rig.pilot("b")
        b.tick()
        out = (a.cycles, a.role, a.health()["enabled"], a.health()["paused"], b.role)
        a.close(release=False)
        b.close(release=False)
        return out

    port, ref = both(rigs, run)
    assert port == ref == (0, "standby", False, False, "pilot")


def test_pause_keeps_the_lease_and_stops_actions(rigs, tmp_path):
    def run(rig):
        journal = str(tmp_path / rig.pkg)
        pilot = rig.pilot(journal_directory=journal)
        rig.feed(0, rig.keys_on(0, 8))
        pilot.pause()
        rig.storm(pilot)
        paused = (pilot.role, pilot.health()["paused"], pilot.actuator.executed)
        pilot.resume()
        rig.storm(pilot, t0=2000.0)
        out = paused, pilot.health()["paused"], pilot.actuator.executed, _strip(rig.p.pilot.read_journal(journal))
        pilot.close(release=False)
        return out

    port, ref = both(rigs, run)
    assert port == ref
    assert port[0] == ("pilot", True, 0) and port[2] > 0
    assert all(r["decisions"] == [{"what": "paused"}] for r in port[3][:3])


def test_dry_run_validates_but_never_moves(rigs, tmp_path):
    def run(rig):
        journal = str(tmp_path / rig.pkg)
        pilot = rig.pilot(dry_run=True, journal_directory=journal)
        keys = rig.keys_on(0, 8)
        rig.feed(0, keys)
        rig.storm(pilot)
        out = (_strip(rig.p.pilot.read_journal(journal)), pilot.actuator.executed,
               [rig.node.pmap.partition_of(k) for k in keys])
        pilot.close(release=False)
        return out

    port, ref = both(rigs, run)
    assert port == ref
    dry = [o for r in port[0] for o in r["outcomes"] if o["outcome"] == "dry_run"]
    assert dry and all(o["plan"]["valid"] for o in dry) and port[1] == 0 and set(port[2]) == {0}


def test_a_storm_is_detected_and_rebalanced_alike(rigs, tmp_path):
    def run(rig):
        journal = str(tmp_path / rig.pkg)
        pilot = rig.pilot(journal_directory=journal)
        keys = rig.keys_on(0, 8)
        rig.feed(0, keys, reps=2)
        rig.storm(pilot, cycles=2)  # one cycle matures the readings, one detects and acts
        moved = [k for k in keys if rig.node.pmap.partition_of(k) != 0]
        for key in moved:
            assert key not in rig.engines[0]._keyed.keys
        out = (pilot.policy.hot, pilot.actuator.executed, [rig.node.pmap.partition_of(k) for k in keys],
               [rig.value(k) for k in keys], pilot.health()["hot_partitions"],
               _strip(rig.p.pilot.read_journal(journal)))
        pilot.close(release=False)
        return out

    port, ref = both(rigs, run)
    assert port == ref
    assert port[0] == ("p0",) and port[1] == 6 and sum(p != 0 for p in port[2]) == 6 and set(port[3]) == {3.0}


def test_stale_workers_are_excluded_not_guessed(rigs):
    def run(rig):
        pilot = rig.pilot()
        rig.aggregator.ingest(make_snapshot(rig.pkg, "lagger", 500.0, submitted={"p1": 0.0}, depth={"p1": 999.0}))
        rig.clock.advance(60.0)  # past stale_after_s=10
        pilot.tick()
        out = (pilot.signals.excluded_stale, pilot.health()["excluded_stale"], pilot.signals.backlog_total)
        pilot.close(release=False)
        return out

    port, ref = both(rigs, run)
    assert port[:2] == ref[:2] == (["lagger"], ["lagger"])
    assert port[2] == pytest.approx(0.0) and ref[2] == pytest.approx(0.0)


# --------------------------------------------------------------------------- the port's own telemetry


def test_a_signal_book_sees_a_port_engines_partition_rate():
    """A port engine under a port ``PartitionedNode`` carries its partition's
    name on its series; snapshots of the port's registry, read by the port's
    ``SignalBook``, give that partition a write rate. Under the JAX package's
    family names the same snapshots read as an idle fleet."""
    tobs.reset()  # the book rates on deltas by (node, partition): no earlier engine's series
    rig = PilotRig("port")
    try:
        agg = tfleet.FleetAggregator(stale_after_s=10.0, retire_after_s=600.0)
        book = tpilot.SignalBook(alpha=1.0)
        keys = rig.keys_on(2, 3)
        snaps = []
        for _ in range(2):
            rig.feed(2, keys, reps=20)
            snaps.append(tfleet.node_snapshot("host-x"))
            time.sleep(0.01)
        for snap in snaps:
            agg.ingest(snap)
            book.ingest(agg)
        rates = {p: r.rate for p, r in book.readings().items()}
        assert rates["p2"] > 0 and rates["p2"] == max(rates.values())
        blind = tpilot.SignalBook(alpha=1.0)
        names = tsignals._EVENTS, tsignals._DEPTH, tsignals._QUANTILE
        try:
            tsignals._EVENTS, tsignals._DEPTH, tsignals._QUANTILE = (
                n.replace("metrics_tpu_torch_", "metrics_tpu_", 1) for n in names)
            agg2 = tfleet.FleetAggregator(stale_after_s=10.0, retire_after_s=600.0)
            for snap in snaps:
                agg2.ingest(snap)
                blind.ingest(agg2)
        finally:
            tsignals._EVENTS, tsignals._DEPTH, tsignals._QUANTILE = names
        assert blind.readings() == {}
    finally:
        rig.close()


def test_an_autopilot_spreads_a_hot_partition_it_sees_only_through_its_own_registry(tmp_path):
    """No crafted snapshot: the pilot's observation is the port registry's
    snapshot of its own engines. Partition p0 takes every write; the pilot
    flags it and moves tenants off it, and every tenant keeps its state."""
    tobs.reset()
    rig = PilotRig("port", node_id="solo")
    try:
        pilot = rig.pilot("solo", journal_directory=str(tmp_path / "journal"))
        hot = rig.keys_on(0, 8, prefix="hot")
        quiet = [k for pid in range(1, P) for k in rig.keys_on(pid, 1, prefix="quiet")]
        rig.feed(0, hot)
        for pid, key in zip(range(1, P), quiet):
            rig.feed(pid, [key])
        for _ in range(4):
            for key in hot:  # routed by the live map, as a client would
                rig.feed(rig.node.pmap.partition_of(key), [key], reps=10)
            time.sleep(0.01)
            pilot.tick()
            rig.clock.advance(1.5)
        assert pilot.actuator.executed == 6 and pilot.actuator.failures == 0
        edges = [d["what"] for r in tpilot.read_journal(str(tmp_path / "journal")) for d in r["decisions"]]
        assert edges[:2] == ["partition_hot", "rebalance_planned"] and "partition_cooled" in edges
        assert pilot.last_error is None
        assert len({rig.node.pmap.partition_of(k) for k in hot}) >= 3
        stayed = [k for k in hot if rig.node.pmap.partition_of(k) == 0]
        assert len(stayed) == 2
        records = tpilot.read_journal(str(tmp_path / "journal"))
        assert sum(o["outcome"] == "ok" for r in records for o in r["outcomes"]) == 6
        assert all(rig.value(k) > 0 for k in hot + quiet)
        pilot.close(release=False)
    finally:
        rig.close()
