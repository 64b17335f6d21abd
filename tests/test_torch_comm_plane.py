"""The comm plane's host path against the JAX package's, end to end.

The same per-rank states (each rank's seeded batch folded through the port's
``update_state``, handed to the JAX side as arrays of the same values) go
through both packages' ``LoopbackWorld``
under the same fault scripts: the aggregators, ``BinaryAccuracy``,
``BinaryConfusionMatrix``, ``BinaryAUROC``'s list states, ``MeanSquaredError``
and the flagship collection (synced per member, as the engine syncs it).
Synced states: integer leaves and int8-decoded leaves bit-identical, float
leaves bit-identical at world 2 and within rtol 1e-6 at world 4 (the order of
addition may differ). ``SyncReport``s: the same bytes, ``degraded_step``,
retries, timeouts and staleness.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
from metrics_tpu import comm as jcomm
from metrics_tpu.parallel.sync import sync_state_host as jax_sync_state_host
from metrics_tpu.utils.distributed import gather_all_tensors as jax_gather_all_tensors
import metrics_tpu_torch
from metrics_tpu_torch import comm, obs
from metrics_tpu_torch.obs import instrument
from metrics_tpu_torch.parallel.sync import sync_state_host
from metrics_tpu_torch.utils.distributed import gather_all_tensors

PACKAGES = {"port": (comm, sync_state_host), "jax": (jcomm, jax_sync_state_host)}


@pytest.fixture(autouse=True)
def _isolated():
    comm.clear_plan_cache()
    jcomm.clear_plan_cache()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _families():
    return {
        "sum": lambda p: p.aggregation.SumMetric(**_kw(p)),
        "mean": lambda p: p.aggregation.MeanMetric(**_kw(p)),
        "max": lambda p: p.aggregation.MaxMetric(**_kw(p)),
        "min": lambda p: p.aggregation.MinMetric(**_kw(p)),
        "cat": lambda p: p.aggregation.CatMetric(**_kw(p)),
        "binary_accuracy": lambda p: p.classification.BinaryAccuracy(**_kw(p)),
        "binary_confmat": lambda p: p.classification.BinaryConfusionMatrix(**_kw(p)),
        "binary_auroc": lambda p: p.classification.BinaryAUROC(thresholds=None, **_kw(p)),
        "mse": lambda p: p.regression.MeanSquaredError(**_kw(p)),
        "flagship": lambda p: p.collections.MetricCollection({
            "accuracy": p.classification.MulticlassAccuracy(7, average="micro", **_kw(p)),
            "f1": p.classification.MulticlassF1Score(7, average="macro", **_kw(p)),
            "confmat": p.classification.MulticlassConfusionMatrix(7, **_kw(p)),
        }),
    }


def _kw(pkg):
    return {"device": "cpu"} if pkg is metrics_tpu_torch else {}


def _batch(family, rank, seed):
    rng = np.random.default_rng(1000 * seed + rank)
    n = 1100 + 37 * rank  # ragged cat states across ranks, above int8's 4096-byte floor
    if family in ("sum", "mean", "max", "min", "cat"):
        return (rng.standard_normal(n).astype(np.float32),)
    if family == "mse":
        return rng.standard_normal(n).astype(np.float32), rng.standard_normal(n).astype(np.float32)
    if family == "flagship":
        return rng.integers(0, 7, n).astype(np.int32), rng.integers(0, 7, n).astype(np.int32)
    return rng.random(n).astype(np.float32), rng.integers(0, 2, n).astype(np.int32)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return jnp.asarray(tree.numpy())


def _state(name, family, rank, seed):
    """One rank's state of ``family``: the port folds the rank's batch from a
    fresh ``init_state`` (per member for the collection), and the JAX side
    gets the same values as arrays, so both planes sync the same inputs."""
    port_metric = _families()[family](metrics_tpu_torch)
    args = [torch.from_numpy(a) for a in _batch(family, rank, seed)]
    if family == "flagship":
        state = {k: m.update_state(m.init_state(), *args) for k, m in port_metric._modules.items()}
    else:
        state = port_metric.update_state(port_metric.init_state(), *args)
    if name == "port":
        return port_metric, state
    metric = _families()[family](metrics_tpu)
    assert sorted(_reductions_of(metric)) == sorted(_reductions_of(port_metric))
    return metric, _to_jax(state)


def _reductions_of(metric):
    if hasattr(metric, "_modules"):
        return {(k, n): r for k, m in metric._modules.items() for n, r in m._reductions.items() if isinstance(r, str)}
    return {n: r for n, r in metric._reductions.items() if isinstance(r, str)}


def _sync(name, family, transports, states, metric, config):
    """Run every rank's sync in package ``name``; per-rank (synced, reports)."""
    pkg, host_sync = PACKAGES[name]
    world = len(transports)
    reports = [[] for _ in range(world)]

    def rank_fn(r):
        cfg = replace(config, on_report=lambda rep: reports[r].append(rep))
        if family == "flagship":
            return {k: host_sync(states[r][k], metric._modules[k]._reductions, transport=transports[r],
                                 config=cfg, site="engine.compute") for k in states[r]}
        return host_sync(states[r], metric._reductions, transport=transports[r], config=cfg, site="t.plane")

    if isinstance(transports[0], str):  # one LoopbackWorld, one thread a rank
        lw = pkg.LoopbackWorld(world, timeout=10.0)
        wrap = transports
        transports = [None] * world

        def run(t, r):
            transports[r] = _WRAPPERS[wrap[r]](pkg, t)
            return rank_fn(r)

        out = lw.run([lambda t, r=r: run(t, r) for r in range(world)])
    else:
        out = [rank_fn(r) for r in range(world)]
    return out, reports


_WRAPPERS = {
    "plain": lambda pkg, t: t,
    "flaky": lambda pkg, t: pkg.FlakyTransport(t, fail=1),
    "flaky2": lambda pkg, t: pkg.FlakyTransport(t, fail=2),
}

SCRIPTS = {
    # name: (transport per rank, config kwargs)
    "clean": ("plain", {}),
    "flaky_retry": ("flaky", {"max_retries": 2, "backoff_base_s": 0.001}),
    "int8": ("plain", {"policy": "int8"}),
    "int8_degrades": ("flaky2", {"policy": "int8", "max_retries": 1, "backoff_base_s": 0.001}),
}


def _config(pkg, kwargs):
    kwargs = dict(kwargs)
    if kwargs.get("policy") == "int8":
        kwargs["policy"] = pkg.CodecPolicy(lossy="int8")
    return pkg.CommConfig(**kwargs)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)}


def _assert_states_match(got, want, world, what):
    a, b = _flat(got), _flat(want)
    assert set(a) == set(b), (what, sorted(a), sorted(b))
    for path in a:
        x, y = a[path], b[path]
        assert x.dtype == y.dtype and x.shape == y.shape, (what, path, x.dtype, y.dtype, x.shape, y.shape)
        if np.issubdtype(x.dtype, np.floating) and world > 2:
            np.testing.assert_allclose(x, y, rtol=1e-6, err_msg=f"{what} {path}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {path}")


def _report_view(rep):
    return (rep.site, rep.world, rep.raw_bytes, rep.wire_bytes, rep.retries, rep.timeouts, rep.degraded_step,
            rep.stale, rep.peers_lost, rep.world_live)


def _run_script(family, script, world, seed=0):
    wrapper, cfg_kwargs = SCRIPTS[script]
    out = {}
    for name in PACKAGES:
        pkg = PACKAGES[name][0]
        metric, _ = _state(name, family, 0, seed)
        states = [_state(name, family, r, seed)[1] for r in range(world)]
        out[name] = _sync(name, family, [wrapper] * world, states, metric, _config(pkg, cfg_kwargs))
    return out


@pytest.mark.parametrize("family", list(_families()))
@pytest.mark.parametrize("world", [2, 4])
def test_clean_sync_equals_the_jax_package(family, world):
    out = _run_script(family, "clean", world)
    for r in range(world):
        _assert_states_match(out["port"][0][r], out["jax"][0][r], world, f"{family} rank {r}")
        assert [_report_view(x) for x in out["port"][1][r]] == [_report_view(x) for x in out["jax"][1][r]]
        assert all(x.degraded_step == "none" and not x.stale for x in out["port"][1][r])


@pytest.mark.parametrize("family", list(_families()))
@pytest.mark.parametrize("script", ["flaky_retry", "int8", "int8_degrades"])
def test_fault_scripts_give_the_jax_packages_states_and_reports(family, script):
    world = 2
    out = _run_script(family, script, world, seed=1)
    for r in range(world):
        _assert_states_match(out["port"][0][r], out["jax"][0][r], world, f"{family} {script} rank {r}")
        assert [_report_view(x) for x in out["port"][1][r]] == [_report_view(x) for x in out["jax"][1][r]]


def test_int8_shrinks_the_wire_of_a_cat_state_within_its_bound():
    out = _run_script("cat", "int8", 2, seed=2)
    rep = out["port"][1][0][0]
    # 1100 floats: two padded blocks of int8 codes, their scales and the shape vectors
    assert rep.compression_ratio > 2.0 and rep.degraded_step == "none"
    mine = _batch("cat", 0, 2)[0]
    got = out["port"][0][0]["value"][0].numpy()[: mine.size]
    assert np.all(np.abs(got - mine) <= np.abs(mine).max() / 254.0 + np.abs(mine) * 2.0**-22)


def test_flaky_script_retries_once_and_degrade_ladders_agree():
    flaky = _run_script("binary_auroc", "flaky_retry", 2)["port"][1][0][0]
    assert flaky.retries == 1 and flaky.degraded_step == "none"
    ladder = _run_script("binary_auroc", "int8_degrades", 2)["port"][1][0][0]
    assert ladder.degraded_step == "lossless_only" and not ladder.stale


@pytest.mark.parametrize("name", ["port", "jax"])
def test_timeout_and_dead_peer_scripts(name):
    """Single-caller scripts (a fake world): a stalled first collective times
    out and retries; a dead peer walks the ladder to stale local state."""
    pkg = PACKAGES[name][0]
    metric, state = _state(name, "binary_confmat", 0, 3)
    reports = []
    stall = pkg.StallTransport(pkg.ReplicaFakeTransport(2), stall_s=0.3, stalls=1)
    cfg = pkg.CommConfig(timeout_s=0.05, max_retries=2, backoff_base_s=0.001, on_report=reports.append)
    synced = pkg.sync_pytree(state, metric._reductions, transport=stall, config=cfg, site="t.timeout")
    assert reports[-1].timeouts == 1 and reports[-1].retries == 1 and reports[-1].degraded_step == "none"
    np.testing.assert_array_equal(np.asarray(synced["confmat"]), 2 * np.asarray(state["confmat"]))
    local = pkg.sync_pytree(state, metric._reductions, transport=pkg.DeadPeerTransport(2),
                            config=replace(cfg, timeout_s=None), site="t.dead")
    assert reports[-1].degraded_step == "local_state" and reports[-1].stale and reports[-1].retries == 0
    np.testing.assert_array_equal(np.asarray(local["confmat"]), np.asarray(state["confmat"]))
    with pytest.raises(pkg.TransportError):
        pkg.sync_pytree(state, metric._reductions, transport=pkg.DeadPeerTransport(2),
                        config=replace(cfg, timeout_s=None, degrade=False))


def test_the_ladder_is_counted_in_obs():
    obs.enable()
    metric, state = _state("port", "binary_confmat", 0, 4)
    cfg = comm.CommConfig(max_retries=1, backoff_base_s=0.001)
    comm.sync_pytree(state, metric._reductions, transport=comm.FlakyTransport(comm.ReplicaFakeTransport(2), fail=1),
                     config=cfg, site="t.obs")
    comm.sync_pytree(state, metric._reductions, transport=comm.DeadPeerTransport(2), config=cfg, site="t.obs")
    # the flaky call retries once; a lost peer skips same-step retries
    assert instrument.COMM_RETRIES.value(site="t.obs") == 1
    assert instrument.COMM_DEGRADATIONS.value(site="t.obs", step="local_state") == 1
    assert instrument.COMM_STALE.value(site="t.obs") == 1.0
    raw = instrument.tree_nbytes({k: state[k] for k in metric._reductions}) + 4  # + _update_count
    assert instrument.COMM_RAW_BYTES.value(site="t.obs") == raw
    assert instrument.COMM_RATIO.value(site="t.obs") == 1.0


@pytest.mark.parametrize("world", [2, 3])
def test_injected_gather_fn_path_equals_the_jax_package(world):
    """``sync_state_host(gather_fn=...)``, the reference protocol, over
    ``gather_all_tensors`` on each package's loopback world."""
    out = {}
    for name, (pkg, host_sync) in PACKAGES.items():
        metric, _ = _state(name, "binary_auroc", 0, 5)
        states = [_state(name, "binary_auroc", r, 5)[1] for r in range(world)]
        gather = gather_all_tensors if name == "port" else jax_gather_all_tensors
        lw = pkg.LoopbackWorld(world, timeout=10.0)
        out[name] = lw.run([lambda t, r=r, gather=gather, host_sync=host_sync, states=states, metric=metric: host_sync(
            states[r], metric._reductions, gather_fn=lambda x, group=None: gather(x, transport=t),
            distributed_available_fn=lambda: True) for r in range(world)])
    for r in range(world):
        _assert_states_match(out["port"][r], out["jax"][r], world, f"rank {r}")


def test_single_process_host_sync_is_the_identity():
    metric, state = _state("port", "binary_accuracy", 0, 6)
    assert sync_state_host(state, metric._reductions) is state
    assert isinstance(comm.default_transport(), comm.LocalTransport)


def test_the_on_report_hook_is_absorbed_when_it_raises():
    def bad(rep):
        raise RuntimeError("observer bug")

    metric, state = _state("port", "sum", 0, 7)
    with pytest.warns(UserWarning, match="observer raised"):
        out = comm.sync_pytree(state, metric._reductions, transport=comm.ReplicaFakeTransport(2),
                               config=comm.CommConfig(on_report=bad))
    assert torch.equal(out["sum_value"], 2 * state["sum_value"])
    with comm.use_config(max_retries=7) as cfg:
        assert cfg.max_retries == 7 and comm.get_config().max_retries == 7
    assert comm.get_config().max_retries == 2
