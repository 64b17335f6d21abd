"""The port's autopilot planning (``PilotConfig``, ``SignalBook``, ``Policy``,
``DecisionJournal``) against the JAX package's, on the CPU.

The same fleet snapshots, made with numpy from a seed, go through each
package's ``FleetAggregator`` and ``SignalBook`` under one ``ManualClock``
script (each package reads its own telemetry family names, so each snapshot
is written with the reader's names): the readings, the tier residency, the
backlog and the excluded stale nodes are equal, counter resets and re-ingested
snapshots included. The same readings give both policies the same decisions
and the same plan, over seeded sequences that cross the hysteresis bands,
arm tier retunes and shard growth and hit the per-cycle cap. A journal written
by either package reads back record for record in the other, with the same
bytes, and its sequence resumes across them. Bad configurations raise the
JAX package's errors.
"""

import os

import numpy as np
import pytest

import metrics_tpu.cluster as jc
import metrics_tpu.obs.fleet as jfleet
import metrics_tpu.pilot as jpilot
import metrics_tpu.pilot.signals as jsignals
import metrics_tpu_torch.cluster as tc
import metrics_tpu_torch.obs.fleet as tfleet
import metrics_tpu_torch.pilot as tpilot
import metrics_tpu_torch.pilot.signals as tsignals

PKG = {
    "jax": (jc, jfleet, jpilot, "metrics_tpu_"),
    "port": (tc, tfleet, tpilot, "metrics_tpu_torch_"),
}
PARTS = ("p0", "p1", "p2", "p3")


def make_snapshot(pkg, node, t_wall, *, submitted=None, depth=None, p99=None, tier_hot=None):
    """A node snapshot with exact values, under ``pkg``'s family names."""
    _, fleet, _, prefix = PKG[pkg]
    families = {}
    if submitted:
        families[prefix + "engine_events_total"] = {"type": "counter", "help": "", "samples": [
            [[["engine", "9"], ["partition", part], ["event", "submitted"]], v] for part, v in submitted.items()]}
    if depth:
        families[prefix + "engine_queue_depth"] = {"type": "gauge", "help": "", "samples": [
            [[["engine", "9"], ["partition", part]], v] for part, v in depth.items()]}
    if p99:
        families[prefix + "engine_latency_quantile_seconds"] = {"type": "gauge", "help": "", "samples": [
            [[["engine", "9"], ["partition", part], ["quantile", "0.99"]], v] for part, v in p99.items()]}
    if tier_hot:
        families[prefix + "tier_residency"] = {"type": "gauge", "help": "", "samples": [
            [[["engine", eid], ["tier", "hot"]], v] for eid, v in tier_hot.items()]}
    return {"kind": fleet.SNAPSHOT_KIND, "version": fleet.SNAPSHOT_VERSION, "node": node,
            "t_wall": float(t_wall), "families": families}


def test_the_port_reads_its_own_family_names():
    assert tsignals._EVENTS == "metrics_tpu_torch_engine_events_total"
    assert (tsignals._EVENTS, tsignals._DEPTH, tsignals._QUANTILE, tsignals._RESIDENCY) == tuple(
        name.replace("metrics_tpu_", "metrics_tpu_torch_", 1)
        for name in (jsignals._EVENTS, jsignals._DEPTH, jsignals._QUANTILE, jsignals._RESIDENCY))


# --------------------------------------------------------------------------- config


BAD_CONFIGS = [
    {"node_id": ""},
    {"lease_ttl_s": 0.0},
    {"tick_interval_s": -1.0},
    {"evaluate_interval_s": 0.0},
    {"budget_window_s": 0.0},
    {"tenant_cooldown_s": 0.0},
    {"ewma_alpha": 0.0},
    {"ewma_alpha": 1.5},
    {"min_observations": 0},
    {"min_rate": -1.0},
    {"hot_ratio_high": 1.5, "hot_ratio_low": 1.5},
    {"backlog_high": 8.0, "backlog_low": 8.0},
    {"tier_occupancy_high": 0.4},
    {"hot_ratio_high": 1.2, "hot_ratio_low": 0.5},
    {"tier_retune_factor": 1.0},
    {"tier_capacity_max": 0},
    {"max_shards": 0},
    {"migration_budget": 0},
    {"max_actions_per_cycle": 0},
]


def _config_error(pkg, kw):
    cluster, _, pilot, _ = PKG[pkg]
    args = {"node_id": "a", "store": cluster.FakeCoordStore(clock=cluster.ManualClock(0.0)), **kw}
    with pytest.raises(Exception) as info:
        pilot.PilotConfig(**args)
    return type(info.value).__name__, str(info.value)


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_bad_configs_raise_the_jax_errors(kw):
    assert _config_error("port", kw) == _config_error("jax", kw)


def test_a_config_without_a_store_is_refused_alike():
    for pkg in PKG:
        with pytest.raises(Exception, match="store is required"):
            PKG[pkg][2].PilotConfig(node_id="a", store=None)
    assert tpilot.PILOT_LEASE == jpilot.PILOT_LEASE == "pilot"


# --------------------------------------------------------------------------- signals


def signal_script(seed, cycles=12):
    """A seeded fleet telemetry script: per cycle, each live node's snapshot
    (cumulative submitted counters, depths, p99s, tier residency), with one
    counter reset, one snapshot ingested twice and one node that stops."""
    rng = np.random.default_rng(seed)
    nodes = ["w0", "w1", "w2", "lagger"]
    counters = {n: {p: float(rng.integers(0, 50)) for p in PARTS} for n in nodes}
    script = []
    reset_at, twice_at, stop_at = int(rng.integers(3, cycles)), int(rng.integers(2, cycles)), int(rng.integers(2, 6))
    t = 100.0
    for cycle in range(cycles):
        step = []
        advance = float(rng.choice([0.5, 1.0, 2.5, 7.0]))
        t += advance
        for node in nodes:
            if node == "lagger" and cycle >= stop_at:
                continue
            hot = PARTS[int(rng.integers(0, 4))]
            for p in PARTS:
                counters[node][p] += float(rng.integers(0, 40)) + (400.0 if p == hot else 0.0)
            if cycle == reset_at and node == "w1":
                counters[node]["p2"] = float(rng.integers(0, 5))  # an engine restarted
            submitted = {p: counters[node][p] for p in PARTS if rng.random() < 0.9}
            step.append(dict(node=node, t_wall=t + float(rng.random()), submitted=submitted,
                             depth={p: float(rng.integers(0, 90)) for p in PARTS[: int(rng.integers(1, 5))]},
                             p99={p: float(rng.random()) / 10 for p in PARTS if rng.random() < 0.6},
                             tier_hot={f"e{int(rng.integers(0, 3))}": float(rng.integers(0, 100))}))
        script.append((advance, step, cycle == twice_at))
    return script


def _book_view(book):
    return (
        {p: (r.rate, r.backlog, r.p99_s, r.observations) for p, r in book.readings().items()},
        book.as_doc(), book.backlog_total, book.observations, sorted(book.excluded_stale),
        {e: book.tier_hot(e) for e in ("e0", "e1", "e2", "unseen")},
    )


@pytest.mark.parametrize("alpha", [1.0, 0.4])
@pytest.mark.parametrize("seed", range(6))
def test_signal_books_read_the_same_fleet_alike(seed, alpha):
    script = signal_script(seed)
    views = {}
    for pkg in PKG:
        cluster, fleet, pilot, _ = PKG[pkg]
        clock = cluster.ManualClock(0.0)
        agg = fleet.FleetAggregator(stale_after_s=10.0, retire_after_s=600.0, clock=clock)
        book = pilot.SignalBook(alpha)
        trace = []
        for advance, step, twice in script:
            clock.advance(advance)
            for snap in step:
                agg.ingest(make_snapshot(pkg, snap["node"], snap["t_wall"], submitted=snap["submitted"],
                                         depth=snap["depth"], p99=snap["p99"], tier_hot=snap["tier_hot"]))
            book.ingest(agg)
            if twice:
                book.ingest(agg)  # the same snapshots again: no zero-width interval
            trace.append(_book_view(book))
        views[pkg] = trace
    assert views["port"] == views["jax"]
    assert any(v[4] == ["lagger"] for v in views["port"])  # the stale node was excluded at some point


def test_a_counter_reset_reads_as_quiet_in_both():
    for pkg in PKG:
        cluster, fleet, pilot, _ = PKG[pkg]
        agg = fleet.FleetAggregator(stale_after_s=10.0, retire_after_s=600.0, clock=cluster.ManualClock(0.0))
        book = pilot.SignalBook(alpha=1.0)
        agg.ingest(make_snapshot(pkg, "w", 10.0, submitted={"p0": 500.0}))
        book.ingest(agg)
        agg.ingest(make_snapshot(pkg, "w", 11.0, submitted={"p0": 3.0}))
        book.ingest(agg)
        assert book.readings()["p0"].rate == 0.0
        with pytest.raises(ValueError):
            pilot.SignalBook(0.0)


def test_a_book_ignores_the_other_packages_family_names():
    """The trap of a line-for-line copy: snapshots under the JAX names give the
    port's book no sample at all (and the reverse)."""
    for reader, writer in (("port", "jax"), ("jax", "port")):
        cluster, fleet, pilot, _ = PKG[reader]
        agg = fleet.FleetAggregator(stale_after_s=10.0, retire_after_s=600.0, clock=cluster.ManualClock(0.0))
        book = pilot.SignalBook(alpha=1.0)
        for t, v in ((10.0, 0.0), (11.0, 500.0)):
            agg.ingest(make_snapshot(writer, "w", t, submitted={"p0": v}, depth={"p0": 9.0}))
            book.ingest(agg)
        assert book.readings() == {} and book.backlog_total == 0.0


# --------------------------------------------------------------------------- policy


def policy_script(seed, cycles=10):
    rng = np.random.default_rng(seed)
    script = []
    for _ in range(cycles):
        base = float(rng.choice([0.0, 0.2, 5.0, 20.0]))
        rates = {p: base * float(rng.random()) for p in PARTS}
        if rng.random() < 0.7:
            rates[PARTS[int(rng.integers(0, 4))]] += base * float(rng.choice([1.0, 2.5, 6.0]))
        readings = {p: (rates[p], float(rng.integers(1, 4))) for p in PARTS if rng.random() < 0.95}
        if rng.random() < 0.2:
            readings["unlabeled"] = (50.0, 3.0)
        owned = tuple(int(p) for p in range(4) if rng.random() < 0.8)
        tenants = {pid: [f"t{pid}-{i}" for i in range(int(rng.integers(0, 12)))] for pid in owned}
        tier = {pid: (f"e{pid}", int(rng.choice([8, 64, 1 << 19])),
                      None if rng.random() < 0.2 else float(rng.integers(0, 80)))
                for pid in owned if rng.random() < 0.5}
        shard = (int(rng.choice([1, 4, 64])), float(rng.choice([0.0, 5.0, 30.0, 100.0]))) if rng.random() < 0.7 else None
        script.append((readings, owned, tenants, tier, shard))
    return script


@pytest.mark.parametrize("cap", [8, 3])
@pytest.mark.parametrize("seed", range(8))
def test_policies_make_the_same_plan_from_the_same_readings(seed, cap):
    script = policy_script(seed)
    traces = {}
    for pkg in PKG:
        cluster, _, pilot, _ = PKG[pkg]
        cfg = pilot.PilotConfig(node_id="a", store=cluster.FakeCoordStore(clock=cluster.ManualClock(0.0)),
                                max_actions_per_cycle=cap, max_shards=64, tier_capacity_max=1 << 20)
        policy = pilot.Policy(cfg)
        trace = []
        for readings, owned, tenants, tier, shard in script:
            decisions, actions = policy.plan(
                {p: pilot.Reading(rate=r, observations=int(o)) for p, (r, o) in readings.items()},
                partition_of={p: i for i, p in enumerate(PARTS)}, owned=owned, tenants_of=tenants,
                tier_view=tier, shard_view=shard)
            assert len(actions) <= cap
            trace.append((decisions, [a.describe() for a in actions], [type(a).__name__ for a in actions],
                          policy.hot))
        traces[pkg] = trace
    assert traces["port"] == traces["jax"]


def test_hysteresis_holds_between_the_bands_in_both():
    for pkg in PKG:
        cluster, _, pilot, _ = PKG[pkg]
        policy = pilot.Policy(pilot.PilotConfig(node_id="a", store=cluster.FakeCoordStore()))
        seen = []
        for rates in ({"p0": 100.0, "p1": 10.0, "p2": 10.0, "p3": 10.0},
                      {"p0": 52.0, "p1": 26.0, "p2": 26.0, "p3": 26.0},
                      {"p0": 30.0, "p1": 26.0, "p2": 26.0, "p3": 26.0}):
            policy.plan({p: pilot.Reading(rate=r, observations=2) for p, r in rates.items()},
                        partition_of={p: i for i, p in enumerate(PARTS)}, owned=(), tenants_of={}, tier_view={})
            seen.append(policy.hot)
        assert seen == [("p0",), ("p0",), ()]


# --------------------------------------------------------------------------- journal


DOCS = [
    {"t": 1.5, "node": "a", "decisions": [{"what": "partition_hot", "ratio": 3.25}], "outcomes": []},
    {"t": 2.0, "node": "a", "paused": True, "key": ("tenant", 7), "nested": {"z": 1, "a": [1.0, None]}},
    {"t": 2.5, "node": "b", "outcomes": [{"kind": "migrate_tenant", "outcome": "ok", "tenant": "'t-1'"}]},
]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_journal_of_either_package_reads_in_the_other(tmp_path, writer):
    reader = "port" if writer == "jax" else "jax"
    w, r = PKG[writer][2], PKG[reader][2]
    journal = w.DecisionJournal(str(tmp_path))
    assert [journal.append(d) for d in DOCS] == [0, 1, 2]
    assert r.read_journal(str(tmp_path)) == w.read_journal(str(tmp_path))
    assert [d["seq"] for d in r.read_journal(str(tmp_path), limit=2)] == [0, 1]
    # the lease moved to a host of the other package: its journal numbers on
    other = r.DecisionJournal(str(tmp_path))
    assert other.append({"node": "c"}) == 3
    assert [d["seq"] for d in w.read_journal(str(tmp_path))] == [0, 1, 2, 3]


def test_both_packages_write_the_same_bytes(tmp_path):
    paths = {}
    for pkg in PKG:
        journal = PKG[pkg][2].DecisionJournal(str(tmp_path / pkg))
        for d in DOCS:
            journal.append(d)
        paths[pkg] = journal.path
    assert os.path.basename(paths["port"]) == os.path.basename(paths["jax"]) == "pilot_decisions.log"
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_torn_tail_is_cut_by_either_package(tmp_path, writer):
    reader = "port" if writer == "jax" else "jax"
    journal = PKG[writer][2].DecisionJournal(str(tmp_path))
    for d in DOCS:
        journal.append(d)
    with open(journal.path, "r+b") as fh:
        fh.truncate(os.path.getsize(journal.path) - 3)  # a crash mid-append
    assert [d["seq"] for d in PKG[reader][2].read_journal(str(tmp_path))] == [0, 1]
    survivor = PKG[reader][2].DecisionJournal(str(tmp_path))
    assert survivor.append({"node": "after"}) == 2
    got = PKG[writer][2].read_journal(str(tmp_path))
    assert [(d["seq"], d.get("node")) for d in got] == [(0, "a"), (1, "a"), (2, "after")]
