"""The port's coordination store (``metrics_tpu_torch/cluster/store.py``) against
the JAX package's, on the CPU.

One ``ManualClock`` drives a store of each package through the same script of
grants, renewals, releases, epoch floors, named leases, heartbeats and store
partitions, for both backends (``FakeCoordStore`` and ``DirectoryCoordStore``,
whose wall clock is replaced by the manual one): every step returns the same
lease, the same members or the same error. A directory written by one package
holds the same bytes as the other's and reads back in the other, and two
threads racing an expired lease's CAS on one directory, one of each package,
leave exactly one winner.
"""

import os
import threading

import numpy as np
import pytest

import metrics_tpu.cluster as jc
import metrics_tpu_torch.cluster as tc

NODES = ("a", "b", "c")
NAMES = ("", "p0", "p3")


def _stores(kind, root, clock):
    """A store of each package (JAX, port) on ``clock``."""
    if kind == "fake":
        return jc.FakeCoordStore(clock=clock), tc.FakeCoordStore(clock=clock)
    stores = []
    for pkg, sub in ((jc, "jax"), (tc, "port")):
        store = pkg.DirectoryCoordStore(str(root / sub), durable=False)
        store.now = clock  # the store's wall clock, replaced by the script's
        stores.append(store)
    return tuple(stores)


def _norm(x):
    """A package-neutral view of a store call's result."""
    if x is None:
        return None
    if isinstance(x, (jc.Lease, tc.Lease)):
        return ("lease", x.holder, x.epoch, x.deadline)
    if isinstance(x, (jc.Member, tc.Member)):
        return ("member", x.node_id, x.role, x.health, x.bootstrapped, x.lag_seqs, x.heartbeat, x.fleet, x.parts)
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in sorted(x.items())}
    return x


def _call(store, op, args):
    try:
        return ("ok", _norm(getattr(store, op)(*args[0], **args[1])))
    except Exception as exc:  # noqa: BLE001 — the error itself is compared
        return ("error", type(exc).__name__, str(exc))


def _member(pkg, node, rng, now):
    parts = None
    if rng.random() < 0.5:
        parts = {name or "p1": {"bootstrapped": bool(rng.integers(0, 2)), "lag": int(rng.integers(-1, 4)),
                                "role": "follower", "health": "SERVING"} for name in NAMES}
    fleet = {"kind": "metrics_tpu-fleet-node", "node": node} if rng.random() < 0.3 else None
    return pkg.Member(node_id=node, role=str(rng.choice(["leader", "follower"])),
                      health=str(rng.choice(["SERVING", "DEGRADED"])), bootstrapped=bool(rng.integers(0, 2)),
                      lag_seqs=int(rng.integers(-1, 9)), heartbeat=float(now), fleet=fleet, parts=parts)


def _script(seed, kind, n=60):
    """``(op, args_for_jax, args_for_port)`` steps, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    steps = []
    now = 0.0
    for _ in range(n):
        r = rng.random()
        node = str(rng.choice(NODES))
        name = str(rng.choice(NAMES + (("p-1",) if kind == "directory" else ())))
        if r < 0.25:
            dt = float(rng.choice([0.25, 0.5, 1.0, 2.0, 4.0]))
            now += dt
            steps.append(("advance", dt))
        elif r < 0.55:
            ttl = float(rng.choice([0.0, 1.0, 3.0, 5.0]))
            floor = int(rng.choice([0, 0, 1, 7, 12]))
            kw = {"epoch_floor": floor, "name": name}
            steps.append(("acquire_lease", ((node, ttl), kw), ((node, ttl), kw)))
        elif r < 0.65:
            steps.append(("release_lease", ((node,), {"name": name}), ((node,), {"name": name})))
        elif r < 0.75:
            steps.append(("read_lease", ((), {"name": name}), ((), {"name": name})))
        elif r < 0.9:
            state = rng.bit_generator.state
            jm = _member(jc, node, rng, now)
            rng.bit_generator.state = state
            tm = _member(tc, node, rng, now)
            steps.append(("heartbeat", ((jm,), {}), ((tm,), {})))
        elif kind == "fake" and r < 0.95:
            steps.append((str(rng.choice(["partition", "heal"])), ((node,), {}), ((node,), {})))
        else:
            steps.append(("members", ((), {}), ((), {})))
    return steps


def _run(kind, root, seed):
    clock = tc.ManualClock(0.0)
    jstore, tstore = _stores(kind, root, clock)
    trace = []
    for step in _script(seed, kind):
        if step[0] == "advance":
            clock.advance(step[1])
            continue
        op, jargs, targs = step
        got, want = _call(tstore, op, targs), _call(jstore, op, jargs)
        assert got == want, (seed, op, targs, got, want)
        trace.append(got)
    return trace, jstore, tstore


@pytest.mark.parametrize("kind", ["fake", "directory"])
@pytest.mark.parametrize("seed", range(8))
def test_one_clock_script_gives_the_same_leases_members_and_errors(tmp_path, kind, seed):
    trace, _j, _t = _run(kind, tmp_path, seed)
    outcomes = {t[0] for t in trace}
    assert "ok" in outcomes and len(trace) > 30


def test_the_contract_values_of_a_fixed_script():
    """The JAX store tests' contract, step by step, in both packages."""
    clock = tc.ManualClock(100.0)
    for store, pkg in zip(_stores("fake", None, clock), (jc, tc)):
        assert store.read_lease() is None
        assert _norm(store.acquire_lease("a", 5.0)) == ("lease", "a", 1, 105.0)
        assert store.acquire_lease("b", 5.0) is None
        with pytest.raises(pkg.ClusterConfigError, match="ttl"):
            store.acquire_lease("a", 0.0)
        store.partition("b")
        with pytest.raises(pkg.CoordStoreError, match="partitioned"):
            store.acquire_lease("b", 5.0)
        store.heal("b")
    clock.advance(5.0)
    for store in _stores("fake", None, clock):
        assert store.acquire_lease("b", 5.0, epoch_floor=7).epoch == 7


@pytest.mark.parametrize("seed", range(3))
def test_directories_hold_equal_bytes_and_read_across_packages(tmp_path, seed):
    _trace, jstore, tstore = _run("directory", tmp_path, seed)
    jroot, troot = tmp_path / "jax", tmp_path / "port"
    names = sorted(os.listdir(jroot))
    assert names == sorted(os.listdir(troot)) and names
    for fn in names:
        assert (jroot / fn).read_bytes() == (troot / fn).read_bytes(), fn
    # each package reads the other's directory as its own
    jcross = jc.DirectoryCoordStore(str(troot), durable=False)
    tcross = tc.DirectoryCoordStore(str(jroot), durable=False)
    for name in ("", "p0", "p3"):
        assert _norm(jcross.read_lease(name)) == _norm(jstore.read_lease(name))
        assert _norm(tcross.read_lease(name)) == _norm(tstore.read_lease(name))
    assert _norm(jcross.members()) == _norm(tstore.members()) == _norm(tcross.members())


def test_a_member_with_fleet_and_parts_is_the_same_record(tmp_path):
    clock = tc.ManualClock(3.5)
    jstore, tstore = _stores("directory", tmp_path, clock)
    parts = {"p0": {"bootstrapped": True, "lag": 2, "role": "follower", "health": "SERVING"}}
    fleet = {"kind": "metrics_tpu-fleet-node", "series": [[1, 2.5]]}
    for store, pkg in ((jstore, jc), (tstore, tc)):
        store.heartbeat(pkg.Member("n1", "leader", "SERVING", True, 0, clock(), fleet=fleet, parts=parts))
        store.acquire_lease("n1", 2.0, name="p0")
        store.acquire_lease("n1", 2.0, name="p0")  # a renewal record
    for fn in ("member-n1.rec", "lease-p0-000000000001.rec", "renew-p0-000000000001.rec"):
        assert (tmp_path / "jax" / fn).read_bytes() == (tmp_path / "port" / fn).read_bytes(), fn


@pytest.mark.parametrize("pair", ["jax_port", "port_port"])
def test_two_threads_racing_an_expired_lease_leave_one_winner(tmp_path, pair):
    clock = tc.ManualClock(0.0)
    root = str(tmp_path / "coord")
    makers = (jc.DirectoryCoordStore, tc.DirectoryCoordStore) if pair == "jax_port" else \
        (tc.DirectoryCoordStore, tc.DirectoryCoordStore)
    stores = []
    for make in makers:
        store = make(root, durable=False)
        store.now = clock
        stores.append(store)
    assert stores[0].acquire_lease("seed", 1.0) is not None
    for round_ in range(25):
        clock.advance(2.0)  # the current lease has expired
        barrier = threading.Barrier(2)
        won = [None, None]

        def race(i):
            barrier.wait(timeout=10)
            won[i] = stores[i].acquire_lease(f"n{i}", 1.0)

        threads = [threading.Thread(target=race, args=(i,)) for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=10)
            assert not th.is_alive()
        winners = [w for w in won if w is not None]
        assert len(winners) == 1, (round_, won)
        lease = stores[0].read_lease()
        assert (lease.holder, lease.epoch) == (winners[0].holder, winners[0].epoch) == \
            (stores[1].read_lease().holder, round_ + 2)
