"""The membership layer against the JAX package's: ``WorldView`` bookkeeping,
two-phase ``agree_live_set`` over both packages' loopback worlds, the
live-subset rung of ``sync_pytree`` (exact over the survivors), the quorum
floor, a rejoin, the bounded rounds, and the ``live_set_shrink`` flight dump.
"""

import threading
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu import comm as jcomm
from metrics_tpu.comm.membership import agree_live_set as jax_agree_live_set
from metrics_tpu_torch import comm, obs
from metrics_tpu_torch.comm.membership import MembershipError, WorldView, agree_live_set, view_for
from metrics_tpu_torch.obs.flight import FLIGHT

PACKAGES = {"port": comm, "jax": jcomm}


@pytest.fixture(autouse=True)
def _isolated():
    comm.clear_plan_cache()
    jcomm.clear_plan_cache()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _run_ranks(fns, join_s=30.0):
    results, errors = {}, {}

    def _runner(r, fn):
        try:
            results[r] = fn()
        except BaseException as exc:  # noqa: BLE001 — surfaced to the test
            errors[r] = exc

    threads = {r: threading.Thread(target=_runner, args=(r, fn), daemon=True) for r, fn in fns.items()}
    for t in threads.values():
        t.start()
    for t in threads.values():
        t.join(join_s)
    assert not any(t.is_alive() for t in threads.values()), "a rank deadlocked"
    return results, errors


@pytest.mark.parametrize("name", ["port", "jax"])
def test_world_view_bookkeeping(name):
    WV = comm.WorldView if name == "port" else jcomm.WorldView
    v = WV(4, rank=0)
    assert v.live() == (0, 1, 2, 3) and not v.has_lost()
    v.mark_lost([2, 2, 3])
    assert v.lost() == (2, 3) and v.suspicion() == {2: 2, 3: 1}
    assert v.commit([0, 1, 2]) == (0, 1, 2) and v.lost() == (3,) and v.epoch == 1
    v.mark_lost([0])
    assert v.is_live(0)
    w = WV(3, rank=1)
    w.suspect_all()
    assert w.lost() == (0, 2) and w.live() == (1,)
    assert w.snapshot() == {"world": 3, "rank": 1, "epoch": 0, "live": (1,), "lost": (0, 2),
                            "suspicion": {0: 1, 2: 1}}


def test_view_attaches_once_per_transport():
    t = comm.LoopbackWorld(2).transport(1)
    assert view_for(t) is view_for(t) and view_for(t).rank == 1 and view_for(t).world == 2


@pytest.mark.parametrize("name", ["port", "jax"])
@pytest.mark.parametrize("case", ["full", "dead", "pessimistic"])
def test_agreement_outcomes_equal_across_packages(name, case):
    pkg = PACKAGES[name]
    agree = agree_live_set if name == "port" else jax_agree_live_set
    view = pkg.view_for
    world = pkg.LoopbackWorld(4, timeout=2.0)
    ranks = (0, 1, 2) if case == "dead" else (0, 1, 2, 3)
    transports = {r: world.transport(r) for r in ranks}
    for t in transports.values():
        if case == "dead":
            view(t).mark_lost([3])
        elif case == "pessimistic":
            view(t).suspect_all()
    results, errors = _run_ranks({r: (lambda t=transports[r]: agree(t, view(t), deadline_s=0.5)) for r in ranks})
    assert not errors
    assert set(results.values()) == {ranks}
    for t in transports.values():
        assert view(t).lost() == tuple(r for r in range(4) if r not in ranks) and view(t).epoch == 1


def test_lone_rank_agrees_on_itself():
    t = comm.LoopbackWorld(3, timeout=0.5).transport(1)
    view_for(t).suspect_all()
    assert agree_live_set(t, view_for(t), deadline_s=0.2) == (1,)


def test_rounds_exhaust_into_membership_error():
    class _Board:
        def world_size(self):
            return 2

        def membership_exchange(self, phase, payload, *, deadline_s, expected, watermarks, grace_s=0.0):
            if phase == "prop":
                return {0: (1, (0, 1)), 1: (2, (0, 1))}
            return {0: (3, tuple(payload)), 1: (4, (1,))}  # the peer commits another mask

    with pytest.raises(MembershipError):
        agree_live_set(_Board(), WorldView(2, rank=0), deadline_s=0.05, max_rounds=2)


def _state(pkg, r, rng):
    tp = rng.integers(0, 50, 6).astype(np.int32)
    total = np.float32(rng.standard_normal())
    vals = rng.standard_normal(3 + r).astype(np.float32)
    if pkg == "port":
        return {"tp": torch.from_numpy(tp), "total": torch.tensor(total), "vals": [torch.from_numpy(vals)],
                "_update_count": torch.tensor(r + 1, dtype=torch.int32)}
    return {"tp": jnp.asarray(tp), "total": jnp.asarray(total), "vals": [jnp.asarray(vals)],
            "_update_count": jnp.asarray(r + 1, jnp.int32)}


REDS = {"tp": "sum", "total": "sum", "vals": "cat"}


@pytest.mark.parametrize("world_n,lost", [(4, (3,)), (4, (1, 2)), (3, (1,))])
def test_live_subset_sync_equals_the_jax_package_and_the_survivors_union(world_n, lost):
    survivors = tuple(r for r in range(world_n) if r not in lost)
    out = {}
    for name, pkg in PACKAGES.items():
        world = pkg.LoopbackWorld(world_n, timeout=0.5)
        cfg = pkg.CommConfig(timeout_s=1.0, max_retries=0, backoff_base_s=0.01)
        transports = {r: world.transport(r) for r in survivors}
        for t in transports.values():
            pkg.view_for(t).mark_lost(list(lost))
        states = {r: _state(name, r, np.random.default_rng(r)) for r in survivors}
        reports = {}
        fns = {r: (lambda r=r: pkg.sync_pytree(
            states[r], REDS, transport=transports[r],
            config=replace(cfg, on_report=lambda rep, r=r: reports.__setitem__(r, rep)), site="t.subset"))
            for r in survivors}
        results, errors = _run_ranks(fns)
        assert not errors
        out[name] = (results, reports)
    for r in survivors:
        port, ref = out["port"][0][r], out["jax"][0][r]
        for k in ("tp", "total", "_update_count"):
            np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]))
        np.testing.assert_array_equal(port["vals"][0].numpy(), np.asarray(ref["vals"][0]))
        prep, jrep = out["port"][1][r], out["jax"][1][r]
        assert (prep.degraded_step, prep.peers_lost, prep.world_live, prep.stale) == (
            jrep.degraded_step, jrep.peers_lost, jrep.world_live, jrep.stale) == ("live_subset", lost,
                                                                                  len(survivors), False)
        assert (prep.raw_bytes, prep.wire_bytes) == (jrep.raw_bytes, jrep.wire_bytes)
        union = sum(_state("port", s, np.random.default_rng(s))["tp"] for s in survivors)
        assert torch.equal(port["tp"], union)


def test_below_min_quorum_serves_local_state_flagged_stale():
    world = comm.LoopbackWorld(4, timeout=0.5)
    cfg = comm.CommConfig(timeout_s=1.0, max_retries=0, backoff_base_s=0.01, min_quorum=3)
    transports = {r: world.transport(r) for r in (0, 1)}
    for t in transports.values():
        view_for(t).mark_lost([2, 3])
    reports = {}
    fns = {r: (lambda r=r: comm.sync_pytree(
        {"x": torch.tensor(float(r + 1))}, {"x": "sum"}, transport=transports[r],
        config=replace(cfg, on_report=lambda rep, r=r: reports.__setitem__(r, rep)), site="t.quorum"))
        for r in (0, 1)}
    results, errors = _run_ranks(fns)
    assert not errors
    for r in (0, 1):
        assert float(results[r]["x"]) == float(r + 1)
        assert reports[r].degraded_step == "local_state" and reports[r].stale and reports[r].peers_lost == (2, 3)


def test_rejoin_returns_to_a_full_world_sync():
    world = comm.LoopbackWorld(3, timeout=0.5)
    cfg = comm.CommConfig(timeout_s=1.0, max_retries=0, backoff_base_s=0.01)
    transports = {r: world.transport(r) for r in range(3)}
    for r in (0, 1):
        view_for(transports[r]).mark_lost([2])
    view_for(transports[2]).suspect_all()  # the returning rank re-agrees before its first sync
    reports = {}
    fns = {r: (lambda r=r: comm.sync_pytree(
        {"x": torch.tensor(r + 1, dtype=torch.int32)}, {"x": "sum"}, transport=transports[r],
        config=replace(cfg, on_report=lambda rep, r=r: reports.__setitem__(r, rep))))
        for r in range(3)}
    results, errors = _run_ranks(fns)
    assert not errors
    for r in range(3):
        assert int(results[r]["x"]) == 6 and reports[r].degraded_step == "none" and reports[r].world_live == 3


def test_a_shrinking_live_set_dumps_a_flight_bundle():
    obs.enable()
    before = len(FLIGHT.bundles())
    v = WorldView(4, rank=0)
    v.commit([0, 1, 2, 3])
    assert len(FLIGHT.bundles()) == before  # no shrink: an edge in the ring only
    v.commit([0, 2, 3])
    bundles = FLIGHT.bundles()[before:]
    assert [b["trigger"] for b in bundles] == ["live_set_shrink"]
    assert bundles[0]["trigger_attrs"]["lost"] == [1]
    assert any(e["kind"] == "comm_live_set" for e in FLIGHT.events())
