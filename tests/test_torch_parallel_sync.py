"""``reduce_in_trace`` and the ``axis_name`` paths of the port in real gloo
worlds of CPU processes, against the JAX package's ``shard_map`` on the
8-device CPU mesh.

One world of 2 processes (a ``DeviceMesh`` with one dimension, ``dp``) and one
of 4 (``(dp, sp) = (2, 2)``) are spawned once each; every rank runs all its
cases and saves numpy results. Rank ``r`` holds the ``r``-th block of each
global input, as the JAX device at the same row-major mesh position does. The
cases: every ``reduce_fx`` (sum, mean, max, min on float32 and int32; cat,
None and a callable) with no codec, ``int8`` and ``fp16``; the gather order
over ``("dp", "sp")`` and ``("sp", "dp")``; a ``ProcessGroup`` axis;
``Metric``/``MetricCollection.compute_from(axis_name=...)`` and a metric's
own ``axis_name``; the data-parallel entry step and ``dryrun_data_parallel``;
``gather_all_tensors`` over ``torch.distributed``; the engine's
``compute(sync=True)`` / ``compute_all(sync=True)`` against one JAX engine
fed every rank's requests; at world 4, a ``Metric(process_group=sub)``
synced over a 2-rank subgroup by its members only; and, in every process, a
second world after the first was destroyed.

Tolerances: integer results bit-identical; float sums bit-identical at world
2 and within rtol 1e-6 at world 4; int8 and fp16 decodes bit-identical;
metric values computed from the synced states (float divisions) within rtol
1e-6; the training step's float loss and weights within rtol 1e-5 (matrix
products).
This module imports JAX only inside the tests, so the spawned ranks do not.
"""

import datetime
import pickle
import socket

import numpy as np
import pytest
import torch

C = 5  # classes of the metrics
BIG = 2000  # elements of the codec cases: two int8 blocks, one padded
DRY = {"batch": 4, "seq": 8, "hidden": 16, "classes": C, "layers": 2}
ENGINE_REQS = 24  # requests a rank serves, over two tenants


def _axes(world):
    if world == 2:
        return {"dp": "dp"}
    return {"dp": "dp", "dp_sp": ("dp", "sp"), "sp_dp": ("sp", "dp")}


def _inputs(rank):
    rng = np.random.default_rng(500 + rank)
    return {"f": rng.standard_normal((6, 3)).astype(np.float32),
            "i": rng.integers(-50, 50, (5,)).astype(np.int32),
            "big": (rng.standard_normal(BIG) * (1 + rank)).astype(np.float32)}


def _cases():
    """``name -> (input, reduce_fx, codec)``; a callable is named ``"spread"``."""
    cases = {}
    for fx in ("sum", "mean", "max", "min"):
        for key in ("f", "i"):
            cases[f"{fx}_{key}"] = (key, fx, None)
    for fx in ("cat", None, "spread"):
        cases[f"{fx}_f"] = ("f", fx, None)
        cases[f"{fx}_i"] = ("i", fx, None)
        for codec in ("int8", "fp16"):
            cases[f"{fx}_big_{codec}"] = ("big", fx, codec)
    cases["cat_f_int8"] = ("f", "cat", "int8")
    return cases


def _labels(rank, n=40):
    rng = np.random.default_rng(900 + rank)
    return (rng.integers(0, C, n).astype(np.int64), rng.integers(0, C, n).astype(np.int64),
            rng.random(n).astype(np.float32), rng.integers(0, 2, n).astype(np.int64),
            rng.standard_normal(n).astype(np.float32))


def _engine_reqs(rank):
    rng = np.random.default_rng(700 + rank)
    return [("ab"[k % 2], rng.integers(0, C, 1 + k % 3), rng.integers(0, C, 1 + k % 3)) for k in range(ENGINE_REQS)]


# ---------------------------------------------------------------------- one rank


def _port_metrics(device="cpu"):
    from metrics_tpu_torch import classification as cls
    from metrics_tpu_torch.regression import MeanSquaredError

    return {"accuracy": cls.MulticlassAccuracy(C, average="micro", device=device),
            "confmat": cls.MulticlassConfusionMatrix(C, device=device),
            "auroc": cls.BinaryAUROC(thresholds=None, device=device),
            "mse": MeanSquaredError(device=device)}


def _flagship(cls, **kw):
    return {"accuracy": cls.MulticlassAccuracy(C, average="micro", **kw),
            "f1": cls.MulticlassF1Score(C, average="macro", **kw),
            "confmat": cls.MulticlassConfusionMatrix(C, **kw)}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) else tree


def _metric_args(name, rank):
    preds, target, scores, binary, reg = (torch.from_numpy(a) for a in _labels(rank))
    return {"accuracy": (preds, target), "confmat": (preds, target), "auroc": (scores, binary),
            "mse": (reg, reg * 0.5 + 0.1)}[name]


def _rank_cases(world, rank):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from metrics_tpu_torch import classification as cls
    from metrics_tpu_torch import comm, entry
    from metrics_tpu_torch.collections import MetricCollection
    from metrics_tpu_torch.engine import StreamingEngine
    from metrics_tpu_torch.parallel.sync import reduce_in_trace, use_mesh
    from metrics_tpu_torch.utils.distributed import gather_all_tensors

    mesh = init_device_mesh("cpu", (2,) if world == 2 else (2, 2), mesh_dim_names=("dp",) if world == 2 else ("dp", "sp"))
    out = {}
    x = {k: torch.from_numpy(v) for k, v in _inputs(rank).items()}
    with use_mesh(mesh):
        for axis_key, axis in _axes(world).items():
            for name, (key, fx, codec) in _cases().items():
                fn = (lambda s: s.amax(0) - s.amin(0)) if fx == "spread" else fx
                got = reduce_in_trace(x[key], fn, axis, codec=codec)
                out[f"reduce/{axis_key}/{name}"] = got.numpy()
                if fx in ("sum", "max"):
                    assert torch.equal(x[key], torch.from_numpy(_inputs(rank)[key]))  # the input is left alone
        out["reduce/group/sum_f"] = reduce_in_trace(x["f"], "sum", dist.group.WORLD).numpy()

        values = {}
        for name, m in _port_metrics().items():
            state = m.update_state(m.init_state(), *_metric_args(name, rank))
            values[name] = m.compute_from(state, axis_name="dp")
        own = cls.MulticlassConfusionMatrix(C, device="cpu", axis_name="dp")
        values["confmat_own_axis"] = own.compute_from(own.update_state(own.init_state(), *_metric_args("confmat", rank)))
        col = MetricCollection(_flagship(cls, device="cpu"))
        preds, target = _metric_args("accuracy", rank)
        col_state = col.update_state(col.init_state(), preds, target)
        values["collection"] = col.compute_from(col_state, axis_name="dp")
        values["collection_synced_states"] = col.sync_state(col_state, "dp")
        out["metrics"] = _np(values)

        params, gx, gy = entry.make_inputs(3, DRY["batch"] * 2, DRY["hidden"], C, DRY["layers"], "cpu")
        dp_i = mesh.get_local_rank("dp")
        rows = slice(dp_i * DRY["batch"], (dp_i + 1) * DRY["batch"])
        metrics = entry.make_metrics(C, "cpu")
        step = entry.make_dp_step(metrics)
        loss, new_params, states, vals = step(params, {n: m.init_state() for n, m in metrics.items()}, gx[rows], gy[rows])
        out["dp_step"] = _np({"loss": loss, "params": new_params, "values": vals, "states": states})
    if world == 4:
        out["dryrun"] = _np(entry.dryrun_data_parallel(mesh, device="cpu", seed=5, **DRY))

    same = gather_all_tensors(torch.full((3,), rank, dtype=torch.int32))
    skewed = gather_all_tensors(torch.arange(2 + 20 * (rank == 0)))  # exact broadcasts
    out["gather"] = _np({"same": same, "skewed": skewed})
    assert comm.default_transport().name == "multihost"

    engine = StreamingEngine(MetricCollection(_flagship(cls, device="cpu")), buckets=(8,), device="cpu")
    try:
        futures = [engine.submit(key, torch.from_numpy(p), torch.from_numpy(t)) for key, p, t in _engine_reqs(rank)]
        for f in futures:
            f.result(timeout=60)
        out["engine"] = _np({"a": engine.compute("a", sync=True), "all": engine.compute_all(sync=True),
                             "local": engine.compute("a")})
        report = comm.last_report()
        out["engine_report"] = (report.site, report.degraded_step, report.world, report.raw_bytes, report.stale)
    finally:
        engine.close()
    return out


def _subgroup_cases(rank):
    """At world 4 each pair, (0, 2) and (1, 3), makes subgroups that only its
    members enter and syncs a ``Metric(process_group=sub)`` and
    ``gather_all_tensors(x, group=sub)`` over them: once on the gloo subgroup
    itself, and once with the subgroup's backend reported as ``nccl``, so the
    host path makes the subgroup's gloo twin on the members only."""
    from unittest import mock

    import torch.distributed as dist

    from metrics_tpu_torch import classification as cls
    from metrics_tpu_torch.comm import transport
    from metrics_tpu_torch.utils.distributed import gather_all_tensors

    pair = [rank % 2, rank % 2 + 2]
    get_backend = dist.get_backend
    out = {}
    for route in ("gloo", "twin"):
        sub = dist.new_group(pair, use_local_synchronization=True)
        fake = (lambda g=None, sub=sub: "nccl" if g is sub else get_backend(g)) if route == "twin" else get_backend
        with mock.patch.object(dist, "get_backend", fake):
            m = cls.MulticlassConfusionMatrix(C, device="cpu", process_group=sub)
            m.update(*_metric_args("confmat", rank))
            host = transport._HOST_GROUPS.get(sub)
            out[route] = {"confmat": m.compute().numpy(),
                          "gather": [t.numpy() for t in gather_all_tensors(torch.arange(1 + rank), group=sub)],
                          "host_ranks": dist.get_process_group_ranks(transport._HOST_GROUPS[sub]),
                          "host_is_sub": transport._HOST_GROUPS[sub] is sub, "cached_before": host is not None}
    return out


def _second_world_cases(world, rank):
    """A new world in a process whose first world was destroyed: the host
    transport and the mesh groups take the new world's groups."""
    from torch.distributed.device_mesh import init_device_mesh

    from metrics_tpu_torch.comm import axis, transport
    from metrics_tpu_torch.parallel.sync import reduce_in_trace, use_mesh
    from metrics_tpu_torch.utils.distributed import gather_all_tensors

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("dp",))
    with use_mesh(mesh):
        summed = reduce_in_trace(torch.full((2,), rank + 1), "sum", "dp")
    gathered = gather_all_tensors(torch.full((2,), rank))
    return {"sum": summed.numpy(), "gather": [t.numpy() for t in gathered],
            "host_is_world": transport._HOST_GROUPS[None] is torch.distributed.group.WORLD,
            "mesh_groups": len(axis._GROUPS)}


def _worker(rank, world, ports, out_dir):
    # a collective or a group that some rank never enters fails in a minute instead of hanging
    kw = {"world_size": world, "rank": rank, "timeout": datetime.timedelta(seconds=60)}
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{ports[0]}", **kw)
    try:
        result = _rank_cases(world, rank)
        if world == 4:
            result["subgroup"] = _subgroup_cases(rank)
    finally:
        torch.distributed.destroy_process_group()
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{ports[1]}", **kw)
    try:
        result["second_world"] = _second_world_cases(world, rank)
    finally:
        torch.distributed.destroy_process_group()
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(world, tmp_path_factory):
    import torch.multiprocessing as mp

    out_dir = tmp_path_factory.mktemp(f"world{world}")
    mp.spawn(_worker, args=(world, (_free_port(), _free_port()), str(out_dir)), nprocs=world, join=True)
    results = []
    for r in range(world):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {world: _spawn(world, tmp_path_factory) for world in (2, 4)}


# ---------------------------------------------------------------------- the JAX side


def _jax_mesh(world):
    import jax
    from jax.sharding import Mesh

    devices = np.asarray(jax.devices()[:world])
    return Mesh(devices, ("dp",)) if world == 2 else Mesh(devices.reshape(2, 2), ("dp", "sp"))


def _smap(fn, mesh, in_specs, out_specs):
    from jax.experimental.shard_map import shard_map

    return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_rep=False)


def _per_rank(world, fn, stacked):
    """Run ``fn`` on every device's block of ``stacked`` (leading axis = rank,
    row-major over the mesh) and return each device's result, by rank."""
    import jax
    from jax.sharding import PartitionSpec as P

    mesh = _jax_mesh(world)
    spec = P(mesh.axis_names)
    out = jax.jit(_smap(lambda *a: jax.tree.map(lambda y: y[None], fn(*(b[0] for b in a))),
                        mesh, tuple(spec for _ in stacked), spec))(*stacked)
    return jax.tree.map(np.asarray, out)


def _jax_reduce_results(world):
    import jax.numpy as jnp

    from metrics_tpu.parallel.sync import reduce_in_trace

    stacked = {k: jnp.asarray(np.stack([_inputs(r)[k] for r in range(world)])) for k in ("f", "i", "big")}

    def fn(f, i, big):
        x = {"f": f, "i": i, "big": big}
        res = {}
        for axis_key, axis in _axes(world).items():
            for name, (key, fx, codec) in _cases().items():
                red = (lambda s: jnp.max(s, 0) - jnp.min(s, 0)) if fx == "spread" else fx
                res[f"{axis_key}/{name}"] = reduce_in_trace(x[key], red, axis, codec=codec)
        return res

    return _per_rank(world, fn, (stacked["f"], stacked["i"], stacked["big"]))


def _assert_close(got, want, world, what, rtol_float=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    if np.issubdtype(got.dtype, np.floating) and (rtol_float or world > 2):
        np.testing.assert_allclose(got, want, rtol=rtol_float or 1e-6, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("world", [2, 4])
def test_reduce_in_trace_equals_shard_map_for_every_reduce_fx_codec_and_axis(worlds, world):
    want = _jax_reduce_results(world)
    for r in range(world):
        for key, value in want.items():
            _assert_close(worlds[world][r][f"reduce/{key}"], value[r], world, f"world {world} rank {r} {key}")


def test_the_gather_order_over_two_mesh_axes_is_row_major_in_the_order_named(worlds):
    """At (dp, sp) = (2, 2): ``("dp", "sp")`` stacks ranks 0, 1, 2, 3 and
    ``("sp", "dp")`` stacks ranks 0, 2, 1, 3, as ``lax.all_gather`` does."""
    rows = [_inputs(r)["i"] for r in range(4)]
    for r in range(4):
        got = worlds[4][r]
        np.testing.assert_array_equal(got["reduce/dp_sp/None_i"], np.stack(rows))
        np.testing.assert_array_equal(got["reduce/sp_dp/None_i"], np.stack([rows[k] for k in (0, 2, 1, 3)]))
        dp_peers = (0, 2) if r % 2 == 0 else (1, 3)
        np.testing.assert_array_equal(got["reduce/dp/cat_i"], np.concatenate([rows[k] for k in dp_peers]))


@pytest.mark.parametrize("world", [2, 4])
def test_a_process_group_axis_reduces_over_its_ranks(worlds, world):
    want = np.sum([_inputs(k)["f"] for k in range(world)], axis=0)
    for r in range(world):
        _assert_close(worlds[world][r]["reduce/group/sum_f"], want, world, f"rank {r}")


@pytest.mark.parametrize("world", [2, 4])
def test_compute_from_with_an_axis_name_equals_the_jax_package(worlds, world):
    import jax.numpy as jnp

    from metrics_tpu import classification as jcls
    from metrics_tpu.collections import MetricCollection as JaxCollection
    from metrics_tpu.regression import MeanSquaredError as JaxMSE

    jax_metrics = {"accuracy": jcls.MulticlassAccuracy(C, average="micro"), "confmat": jcls.MulticlassConfusionMatrix(C),
                   "auroc": jcls.BinaryAUROC(thresholds=None), "mse": JaxMSE()}
    col = JaxCollection(_flagship(jcls))
    stacked = [jnp.asarray(np.stack([_labels(r)[k] for r in range(world)]).astype(
        np.int32 if k in (0, 1, 3) else np.float32)) for k in range(5)]

    def fn(preds, target, scores, binary, reg):
        args = {"accuracy": (preds, target), "confmat": (preds, target), "auroc": (scores, binary),
                "mse": (reg, reg * 0.5 + 0.1)}
        res = {name: m.compute_from(m.update_state(m.init_state(), *args[name]), axis_name="dp")
               for name, m in jax_metrics.items() if name != "auroc"}
        # exact-mode curves compute on the host: the synced state leaves the trace
        auroc = jax_metrics["auroc"]
        res["auroc_state"] = auroc.sync_state(auroc.update_state(auroc.init_state(), *args["auroc"]), "dp")
        res["collection"] = col.compute_from(col.update_state(col.init_state(), preds, target), axis_name="dp")
        return res

    want = _per_rank(world, fn, stacked)
    auroc_states = want.pop("auroc_state")
    want["auroc"] = [np.asarray(jax_metrics["auroc"].compute_from(
        {k: [jnp.asarray(x[r]) for x in v] if isinstance(v, list) else jnp.asarray(v[r]) for k, v in auroc_states.items()}))
        for r in range(world)]
    for r in range(world):
        got = worlds[world][r]["metrics"]
        for name in ("accuracy", "confmat", "auroc", "mse"):
            _assert_close(got[name], want[name][r], world, f"rank {r} {name}", 1e-6)
        _assert_close(got["confmat_own_axis"], want["confmat"][r], world, "a metric's own axis_name")
        for name in want["collection"]:
            _assert_close(got["collection"][name], want["collection"][name][r], world, f"rank {r} collection {name}",
                          1e-6)
        synced = got["collection_synced_states"]
        assert sorted(synced) == ["accuracy", "confmat", "f1"]
        dp_peers = range(world) if world == 2 else ((0, 2) if r % 2 == 0 else (1, 3))
        union = sum(np.bincount(_labels(k)[1] * C + _labels(k)[0], minlength=C * C) for k in dp_peers)
        np.testing.assert_array_equal(synced["confmat"]["confmat"].reshape(-1), union)
        assert synced["confmat"]["_update_count"] == 1  # a rank's own count, as in the JAX package


def _jax_dp_step(world, params, gx, gy):
    """The JAX twin of ``entry.make_dp_step`` in ``shard_map`` over ``dp``:
    per-shard loss and gradients, ``pmean``, SGD, then each metric's
    ``update_state`` → ``sync_state(s, "dp")`` → ``compute_from``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from metrics_tpu import classification as jcls

    metrics = {"accuracy": jcls.MulticlassAccuracy(C, average="micro", validate_args=False),
               "f1": jcls.MulticlassF1Score(C, average="macro", validate_args=False),
               "confmat": jcls.MulticlassConfusionMatrix(C, validate_args=False)}

    def loss_fn(p, x, y):
        h = x
        for w in p["ws"]:
            h = jnp.tanh(h @ w)
        logits = h @ p["head"]
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1)), logits

    def step(p, x, y):
        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, x, y)
        grads = jax.tree.map(lambda g: jax.lax.pmean(g, "dp"), grads)
        p = jax.tree.map(lambda a, g: a - 0.01 * g, p, grads)
        preds = jnp.argmax(logits, axis=-1)
        values = {n: m.compute_from(m.sync_state(m.update_state(m.init_state(), preds, y), "dp"))
                  for n, m in metrics.items()}
        return jax.lax.pmean(loss, "dp"), p, values

    mesh = _jax_mesh(world)
    jp = {"ws": [jnp.asarray(w.numpy()) for w in params["ws"]], "head": jnp.asarray(params["head"].numpy())}
    rep = jax.tree.map(lambda _: P(), jp)
    out = jax.jit(_smap(step, mesh, (rep, P("dp", None), P("dp")), (P(), rep, {n: P() for n in metrics})))(
        jp, jnp.asarray(gx.numpy()), jnp.asarray(gy.numpy().astype(np.int32)))
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("world", [2, 4])
def test_the_data_parallel_entry_step_equals_the_jax_step(worlds, world):
    from metrics_tpu_torch import entry

    params, gx, gy = entry.make_inputs(3, DRY["batch"] * 2, DRY["hidden"], C, DRY["layers"], "cpu")
    loss, new_params, values = _jax_dp_step(world, params, gx, gy)
    for r in range(world):
        got = worlds[world][r]["dp_step"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        for w_got, w_want in zip([*got["params"]["ws"], got["params"]["head"]], [*new_params["ws"], new_params["head"]]):
            np.testing.assert_allclose(w_got, w_want, rtol=1e-5, atol=1e-7)
        for name in ("accuracy", "f1", "confmat"):
            _assert_close(got["values"][name], values[name], world, f"rank {r} {name}", 1e-6)
        assert int(got["states"]["confmat"]["_update_count"]) == 1


def test_dryrun_data_parallel_at_dp_2_sp_2(worlds):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from metrics_tpu.classification import MulticlassAccuracy as JaxAccuracy

    rng = np.random.default_rng(6)
    batch, seq = DRY["batch"] * 2, DRY["seq"] * 2
    preds_tok = rng.integers(0, C, (batch, seq)).astype(np.int32)
    target_tok = rng.integers(0, C, (batch, seq)).astype(np.int32)
    acc = JaxAccuracy(C, average="micro", multidim_average="global", validate_args=False)

    def token_step(p, t):
        s = acc.sync_state(acc.update_state(acc.init_state(), p, t), ("dp", "sp"))
        return acc.compute_from(s)

    import jax

    want = float(jax.jit(_smap(token_step, _jax_mesh(4), (P("dp", "sp"), P("dp", "sp")), P()))(
        jnp.asarray(preds_tok), jnp.asarray(target_tok)))
    for r in range(4):
        got = worlds[4][r]["dryrun"]
        assert np.isfinite(got["loss"])
        assert float(got["token_value"]) == pytest.approx(float(got["token_expected"]), abs=1e-6)
        assert float(got["token_value"]) == want


@pytest.mark.parametrize("world", [2, 4])
def test_gather_all_tensors_over_torch_distributed(worlds, world):
    for r in range(world):
        got = worlds[world][r]["gather"]
        assert [t.tolist() for t in got["same"]] == [[k] * 3 for k in range(world)]
        assert [t.tolist() for t in got["skewed"]] == [list(range(2 + 20 * (k == 0))) for k in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_engine_compute_sync_equals_one_jax_engine_over_every_ranks_requests(worlds, world):
    import jax.numpy as jnp

    from metrics_tpu import classification as jcls
    from metrics_tpu.collections import MetricCollection as JaxCollection
    from metrics_tpu.engine import StreamingEngine as JaxEngine

    engine = JaxEngine(JaxCollection(_flagship(jcls)), buckets=(8,))
    try:
        for r in range(world):
            for key, p, t in _engine_reqs(r):
                engine.submit(key, jnp.asarray(p.astype(np.int32)), jnp.asarray(t.astype(np.int32)))
        engine.flush()
        want = {key: engine.compute(key) for key in "ab"}
    finally:
        engine.close()
    for r in range(world):
        got = worlds[world][r]["engine"]
        for name, value in want["a"].items():
            _assert_close(got["a"][name], np.asarray(value), world, f"rank {r} compute {name}", 1e-6)
            for key in "ab":
                _assert_close(got["all"][key][name], np.asarray(want[key][name]), world, f"rank {r} compute_all {key}",
                              1e-6)
        site, degraded, rep_world, raw, stale = worlds[world][r]["engine_report"]
        assert (site, degraded, rep_world, stale) == ("engine.compute", "none", world, False) and raw > 0
        assert not np.array_equal(got["local"]["confmat"], got["a"]["confmat"])  # the local read is not synced


@pytest.mark.parametrize("route", ["gloo", "twin"])
def test_a_subgroup_syncs_a_metric_on_its_members_only(worlds, route):
    """Ranks (0, 2) and (1, 3) each sync over their own subgroup; the others
    never enter it. ``twin``: the subgroup reports a backend other than gloo,
    so its host buffers take a gloo twin over the same two ranks."""
    import jax.numpy as jnp

    from metrics_tpu import classification as jcls

    for pair in ((0, 2), (1, 3)):
        ref = jcls.MulticlassConfusionMatrix(C)
        for k in pair:
            ref.update(*(jnp.asarray(a) for a in _labels(k)[:2]))
        want = np.asarray(ref.compute())
        for r in pair:
            got = worlds[4][r]["subgroup"][route]
            _assert_close(got["confmat"], want, 2, f"rank {r} {route} confmat")
            assert [g.tolist() for g in got["gather"]] == [list(range(1 + k)) for k in pair]
            assert got["host_ranks"] == list(pair) and not got["cached_before"]
            assert got["host_is_sub"] == (route == "gloo")


@pytest.mark.parametrize("world", [2, 4])
def test_a_second_world_in_the_same_process_takes_its_own_groups(worlds, world):
    want_sum = np.full((2,), sum(r + 1 for r in range(world)))
    for r in range(world):
        got = worlds[world][r]["second_world"]
        np.testing.assert_array_equal(got["sum"], want_sum)
        assert [g.tolist() for g in got["gather"]] == [[k, k] for k in range(world)]
        assert got["host_is_world"] and got["mesh_groups"] == 1
