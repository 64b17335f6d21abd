"""The port's live tenant migration (``metrics_tpu_torch/part/migrate.py``)
against the JAX package's, on the CPU.

Each package migrates the same tenant (live segment and window ring rows) from
a guarded, checkpointed source partition to a checkpointed destination: the
``dry_run`` plan documents are equal, the moved state is bit-identical to the
source's before the move and equal to the JAX package's moved state, and the
manifest commits the override. At each crash point of the destination-first
order (before the import, between the import and the routing commit, between
the commit and the source's eviction, between the eviction and the source's
snapshot) the engines are dropped without a snapshot and restarted from their
directories, by the port and by the JAX package, and after the recovery sweep
the tenant lives on exactly one partition, the one the manifest names, with
its state. The ``partition``-labelled WAL-seq series that ``wal_watermark``
sets matches the JAX package's. Every wait has a deadline.
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest

import metrics_tpu as jm
import metrics_tpu.cluster as jc
import metrics_tpu.engine as jeng
import metrics_tpu.guard as jguard
import metrics_tpu.part as jp
import metrics_tpu_torch as tm
import metrics_tpu_torch.cluster as tc
import metrics_tpu_torch.engine as teng
import metrics_tpu_torch.guard as tguard
import metrics_tpu_torch.part as tp
from metrics_tpu_torch import obs
from tests.test_torch_engine import _one_torch_thread, assert_trees_match  # noqa: F401

WAIT_S = 20
PKG = {
    "jax": SimpleNamespace(top=jm, cluster=jc, engine=jeng, guard=jguard, part=jp, cpu={}),
    "port": SimpleNamespace(top=tm, cluster=tc, engine=teng, guard=tguard, part=tp, cpu={"device": "cpu"}),
}
ROUNDS = ((1.0, 2.0), (3.0,), (4.0, 5.0))  # live segment AND window ring rows


def key_on(pmap, pid, prefix="tenant"):
    return next(k for i in range(1000) if pmap.partition_of(k := f"{prefix}-{i}") == pid)


def make_engine(pkg, directory, *, guard=False):
    p = PKG[pkg]
    return p.engine.StreamingEngine(
        p.top.SumMetric(**p.cpu), window=3, buckets=(8,),
        guard=p.guard.GuardConfig(shed=False) if guard else None,
        checkpoint=p.engine.CheckpointConfig(directory=str(directory), wal_flush="fsync"))


def feed(engine, key, rounds=ROUNDS):
    for i, values in enumerate(rounds):
        if i:
            engine.rotate_window()
        for v in values:
            engine.submit(key, np.array([v], np.float32))
        engine.flush()


class Rig:
    """A manifest-pinned 2-partition map and its two engines, of one package."""

    def __init__(self, pkg, root):
        self.pkg, self.root = pkg, root
        self.p = PKG[pkg]
        self.pmap = self.p.part.PartitionMap(2, seed=1, directory=str(root / "pmap"))
        self.src = make_engine(pkg, root / "p0", guard=True)
        self.dst = make_engine(pkg, root / "p1")
        self.key = key_on(self.pmap, 0)

    def migrate(self, **kw):
        return self.p.part.migrate_tenant(self.key, 1, pmap=self.pmap, src_engine=self.src, dst_engine=self.dst,
                                          **kw)

    def close(self):
        self.src.close()
        self.dst.close()


@pytest.fixture
def rigs(tmp_path):
    made = []

    def make(pkg):
        made.append(Rig(pkg, tmp_path / f"{pkg}{len(made)}"))
        return made[-1]

    yield make
    for r in made:
        r.close()


def _entry(engine, key):
    """An exported entry without the ``rot`` stamp (the importer's own counter)."""
    entry = engine.export_tenant(key, retire=False)
    return None if entry is None else {"state": entry["state"], "ring": entry["ring"]}


# --------------------------------------------------------------------------- the plan


@pytest.mark.parametrize("case", ["valid", "unknown", "noop", "follower_destination"])
def test_dry_run_plan_document_equals_jax(rigs, case):
    plans = []
    for pkg in ("jax", "port"):
        r = rigs(pkg)
        if case != "unknown":
            feed(r.src, r.key)
        if case == "follower_destination":
            r.dst._repl_follower = True
        try:
            plans.append(r.p.part.migrate_tenant(r.key, 0 if case == "noop" else 1, pmap=r.pmap, src_engine=r.src,
                                                 dst_engine=r.dst, dry_run=True))
        finally:
            r.dst._repl_follower = False
        assert r.pmap.partition_of(r.key) == 0 and r.key not in list(r.dst._keyed.keys)
    assert plans[1] == plans[0]
    assert plans[1]["valid"] is (case == "valid")


def test_dry_run_out_of_range_raises_in_both(rigs):
    for pkg in ("jax", "port"):
        r = rigs(pkg)
        feed(r.src, r.key)
        with pytest.raises(Exception, match="out of range"):
            r.p.part.migrate_tenant(r.key, 9, pmap=r.pmap, src_engine=r.src, dst_engine=r.dst, dry_run=True)


# --------------------------------------------------------------------------- the move


def test_a_migration_is_bit_identical_and_equals_jax(rigs):
    moved = {}
    for pkg in ("jax", "port"):
        r = rigs(pkg)
        feed(r.src, r.key)
        before = _entry(r.src, r.key)
        plan = r.migrate(dry_run=True)
        assert r.migrate() is True
        after = _entry(r.dst, r.key)
        assert_trees_match(after, before, f"{pkg} moved")  # every leaf, every ring row
        assert r.pmap.partition_of(r.key) == 1 and r.pmap.epoch_floor(1) == plan["epoch_floor"]
        assert r.p.part.PartitionMap(2, seed=1, directory=r.pmap.directory).partition_of(r.key) == 1
        assert r.key not in list(r.src._keyed.keys)
        with pytest.raises(Exception, match="quarantin"):  # the hold stays on the source
            r.src.submit(r.key, np.array([1.0], np.float32))
        r.dst.submit(r.key, np.array([10.0], np.float32))  # later writes fold onto the moved state
        r.dst.flush()
        moved[pkg] = (after, float(r.dst.compute(r.key)))
    assert_trees_match(moved["port"][0], moved["jax"][0], "port against jax")
    assert moved["port"][1] == moved["jax"][1] == 19.0  # the live segment: 4 + 5 + 10


def test_migration_under_a_sibling_storm(rigs):
    """The barrier is per tenant: a writer that never lets the source go quiet
    does not hold the move up, and the sibling's writes all land."""
    r = rigs("port")
    feed(r.src, r.key)
    sibling = key_on(r.pmap, 0, prefix="noisy")
    want = float(r.src.compute(r.key))
    stop, sent = threading.Event(), [0]

    def storm():
        while not stop.is_set():
            r.src.submit(sibling, np.array([1.0], np.float32))
            sent[0] += 1

    writer = threading.Thread(target=storm, daemon=True)
    writer.start()
    try:
        assert r.migrate() is True
    finally:
        stop.set()
        writer.join(timeout=WAIT_S)
    assert not writer.is_alive()
    r.src.flush()
    assert float(r.dst.compute(r.key)) == want and float(r.src.compute(sibling)) == float(sent[0])


# --------------------------------------------------------------------------- crash points


def _crash_at(r, point):
    """Arm ``migrate_tenant`` to fail at ``point``; returns the error it raises."""
    boom = RuntimeError(f"crash at {point}")

    def fail(*a, **k):
        raise boom

    if point == "import":
        r.dst.import_tenant = fail
    elif point == "commit":
        r.pmap.commit = fail
    elif point == "evict":
        r.src.evict_tenant = fail
    elif point == "src_checkpoint":
        from metrics_tpu_torch.part import migrate as mod

        real = mod._checkpoint_engine
        mod._checkpoint_engine = lambda e: fail() if e is r.src else real(e)
        return boom, lambda: setattr(mod, "_checkpoint_engine", real)
    return boom, lambda: None


@pytest.mark.parametrize("restart", ["port", "jax"])
@pytest.mark.parametrize("point", ["import", "commit", "evict", "src_checkpoint", "none"])
def test_a_restart_at_each_crash_point_keeps_the_tenant_on_one_partition(rigs, point, restart):
    r = rigs("port")
    feed(r.src, r.key)
    before = _entry(r.src, r.key)
    boom, undo = _crash_at(r, point)
    try:
        if point == "none":
            assert r.migrate() is True
        else:
            with pytest.raises(RuntimeError, match="crash at"):
                r.migrate()
    finally:
        undo()
    # the process dies: no final snapshot, the WAL is all that is left beside the last one
    r.src.close(checkpoint=False)
    r.dst.close(checkpoint=False)
    p = PKG[restart]
    pmap = p.part.PartitionMap(2, seed=1, directory=str(r.root / "pmap"))
    engines = {0: make_engine(restart, r.root / "p0"), 1: make_engine(restart, r.root / "p1")}
    r.src, r.dst = engines[0], engines[1]  # closed by the fixture
    p.part.sweep_partitions(pmap, engines)
    holders = [pid for pid, e in engines.items() if r.key in list(e._keyed.keys)]
    assert holders == [pmap.partition_of(r.key)], (point, holders)
    assert holders == ([1] if point in ("evict", "src_checkpoint", "none") else [0])
    assert_trees_match(_entry(engines[holders[0]], r.key), before, f"{point} recovered by {restart}")
    assert p.part.sweep_partitions(pmap, engines) == 0  # a consistent layout sweeps to nothing


# --------------------------------------------------------------------------- the partition series


def _wal_seq_series(pkg, root, text_name):
    p = PKG[pkg]
    store = p.cluster.FakeCoordStore(clock=p.cluster.ManualClock(0.0))
    engines = {pid: make_engine(pkg, root / pkg / f"p{pid}") for pid in range(2)}
    silent = make_engine(pkg, root / pkg / "unlabelled")
    node = p.part.PartitionedNode(engines, p.part.PartConfig(node_id="a", store=store, partitions=2, rng_seed=3),
                                  start=False)
    try:
        node.tick()
        for pid, engine in engines.items():
            for v in range(3 + 2 * pid):
                engine.submit(f"t{v}", np.array([float(v)], np.float32))
            engine.flush()
            assert engine.wal_watermark() == (1, int(engine._wal_seq))
        silent.submit("t", np.array([1.0], np.float32))
        silent.flush()
        silent.wal_watermark()  # no partition label: no series
        registry = (obs.REGISTRY if pkg == "port" else __import__("metrics_tpu").obs.REGISTRY)
        lines = [ln for ln in registry.render_prometheus().splitlines() if ln.startswith(text_name)]
        return sorted((ln.split('partition="')[1].split('"')[0], float(ln.rsplit(" ", 1)[1])) for ln in lines)
    finally:
        node.close()
        for engine in [*engines.values(), silent]:
            engine.close()


def test_wal_watermark_sets_the_partition_series_like_jax(tmp_path):
    from metrics_tpu import obs as jobs

    obs.reset()
    jobs.reset()
    obs.enable()
    jobs.enable()
    try:
        mine = _wal_seq_series("port", tmp_path, "metrics_tpu_torch_part_wal_seq{")
        ref = _wal_seq_series("jax", tmp_path, "metrics_tpu_part_wal_seq{")
        assert mine == ref and [name for name, _ in mine] == ["p0", "p1"]
        text = obs.REGISTRY.render_prometheus()
        assert 'metrics_tpu_torch_part_role{node="a",partition="p1"} 1' in text
    finally:
        obs.disable()
        jobs.disable()
        obs.reset()
        jobs.reset()


def test_stale_map_submit_reloads_and_lands_at_the_new_home(rigs):
    """A client routing on a map from before the move meets the source's hold
    (``TenantQuarantined``), reloads the manifest and retries at the new home."""
    for pkg in ("jax", "port"):
        r = rigs(pkg)
        p = r.p
        feed(r.src, r.key)
        store = p.cluster.FakeCoordStore(clock=p.cluster.ManualClock(0.0))
        for pid in range(2):
            store.acquire_lease("a", 100.0, name=p.part.partition_name(pid))
        stale = p.part.PartitionMap(2, seed=1, directory=r.pmap.directory)
        client = p.part.PartitionedClient(store, {"a": {0: r.src, 1: r.dst}}, pmap=stale, sleep=lambda s: None,
                                          rng_seed=0)
        assert r.migrate() is True
        assert client.partition_of(r.key) == 0  # not reloaded yet
        client.submit(r.key, np.array([100.0], np.float32))
        r.dst.flush()
        assert client.partition_of(r.key) == 1 and float(r.dst.compute(r.key)) == 109.0  # 4 + 5 + 100
