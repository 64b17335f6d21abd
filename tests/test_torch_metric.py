"""The port's ``Metric`` base class against the JAX package's, on the CPU.

One small metric is written twice, once on each base class, with a sum state,
a max state, a mean state and a ragged "cat" state. The same numpy batches go
through both; states and values must agree exactly: the arithmetic is integer
sums, a max, and float32 divisions of exact operands in the same order. (A
float32 ``mean`` is not used: the two frameworks reduce it differently and
can differ in the last bit.)
"""

import contextlib
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.metric import Metric as JaxMetric
from metrics_tpu.utils.data import dim_zero_cat as jax_dim_zero_cat
from metrics_tpu_torch.classification import MulticlassAccuracy
from metrics_tpu_torch.metric import Metric, zero_state
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError


class JaxProbe(JaxMetric):
    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", jnp.zeros((), jnp.int32), dist_reduce_fx="sum", persistent=True)
        self.add_state("peak", jnp.full((3,), -100, jnp.int32), dist_reduce_fx="max", persistent=True)
        self.add_state("avg", jnp.zeros((), jnp.float32), dist_reduce_fx="mean")
        self.add_state("seen", [], dist_reduce_fx="cat", persistent=True)

    def update(self, x):
        self.total = self.total + jnp.sum(x).astype(jnp.int32)
        self.peak = jnp.maximum(self.peak, jnp.max(x, axis=0).astype(jnp.int32))
        self.avg = jnp.sum(x).astype(jnp.float32) / x.size  # exact operands, one correctly rounded division
        self.seen.append(x[:, 0])

    def compute(self):
        return jnp.stack([self.total.astype(jnp.float32), jnp.sum(self.peak).astype(jnp.float32),
                          self.avg, jnp.sum(jax_dim_zero_cat(self.seen)).astype(jnp.float32)])


class TorchProbe(Metric):
    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", zero_state((), torch.int32, self.device), dist_reduce_fx="sum", persistent=True)
        self.add_state("peak", torch.full((3,), -100, dtype=torch.int32), dist_reduce_fx="max", persistent=True)
        self.add_state("avg", zero_state((), torch.float32, self.device), dist_reduce_fx="mean")
        self.add_state("seen", [], dist_reduce_fx="cat", persistent=True)

    def update(self, x):
        self.total = self.total + x.sum().to(torch.int32)
        self.peak = torch.maximum(self.peak, x.amax(dim=0).to(torch.int32))
        self.avg = x.sum().to(torch.float32) / x.numel()
        self.seen.append(x[:, 0])

    def compute(self):
        return torch.stack([self.total.float(), self.peak.sum().float(), self.avg, dim_zero_cat(self.seen).sum().float()])


class JaxProbeFull(JaxProbe):
    full_state_update = True


class TorchProbeFull(TorchProbe):
    full_state_update = True


def _batches(seed=0, n=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(-50, 50, (int(rng.integers(3, 9)), 3)).astype(np.int32) for _ in range(n)]


def _assert_state_equal(jax_state, torch_state):
    assert set(jax_state) == set(torch_state)
    for key, want in jax_state.items():
        got = torch_state[key]
        if isinstance(want, list):
            assert len(got) == len(want), key
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            continue
        want = np.asarray(want)
        got = got if isinstance(got, torch.Tensor) else torch.tensor(got)
        assert str(got.dtype).replace("torch.", "") == str(want.dtype), key
        np.testing.assert_array_equal(got.numpy(), want, err_msg=key)


def test_metric_without_device_raises_on_a_gpu_less_machine():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: device=None resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchProbe()


def test_add_state_rejects_what_the_jax_package_rejects():
    m = TorchProbe(device="cpu")
    with pytest.raises(ValueError):
        m.add_state("bad", [1])
    with pytest.raises(ValueError):
        m.add_state("bad", torch.zeros(()), dist_reduce_fx="median")
    with pytest.raises(ValueError):
        m.add_state("update", torch.zeros(()))
    with pytest.raises(ValueError):
        TorchProbe(device="cpu", not_a_kwarg=1)
    with pytest.raises(RuntimeError):
        m.full_state_update = True


@pytest.mark.parametrize("pair", [(JaxProbe, TorchProbe), (JaxProbeFull, TorchProbeFull)], ids=["reduce", "full"])
def test_update_forward_compute_reset_match_jax(pair):
    jax_cls, torch_cls = pair
    jm, tm = jax_cls(), torch_cls(device="cpu")
    for i, x in enumerate(_batches()):
        if i % 2:
            jm.update(jnp.asarray(x))
            tm.update(torch.from_numpy(x))
        else:
            np.testing.assert_array_equal(tm(torch.from_numpy(x)).numpy(), np.asarray(jm(jnp.asarray(x))))
        assert tm.update_count == jm.update_count
        _assert_state_equal(
            {k: getattr(jm, k) for k in jm._defaults}, {k: getattr(tm, k) for k in tm._defaults}
        )
    np.testing.assert_array_equal(tm.compute().numpy(), np.asarray(jm.compute()))
    tm.reset()
    jm.reset()
    assert tm.update_count == 0 and not tm.update_called
    _assert_state_equal({k: getattr(jm, k) for k in jm._defaults}, {k: getattr(tm, k) for k in tm._defaults})


def test_compute_before_update_warns_and_is_cached():
    tm = TorchProbe(device="cpu")
    tm.update(torch.ones(2, 3, dtype=torch.int32))
    first = tm.compute()
    assert tm.compute() is first  # cached until the next update
    with pytest.warns(UserWarning, match="before the ``update``"):
        MulticlassAccuracy(3, device="cpu").compute()


def test_functional_api_matches_jax_and_is_pure():
    jm, tm = JaxProbe(), TorchProbe(device="cpu")
    js, ts = jm.init_state(), tm.init_state()
    assert ts["_update_count"].dtype == torch.int32
    _assert_state_equal(js, ts)
    for x in _batches(seed=1):
        before = {k: (list(v) if isinstance(v, list) else v.clone()) for k, v in ts.items()}
        new_ts = tm.update_state(ts, torch.from_numpy(x))
        # purity: the given state is left as it was, list states included
        for k, v in before.items():
            if isinstance(v, list):
                assert len(ts[k]) == len(v)
            else:
                assert torch.equal(ts[k], v)
        js, ts = jm.update_state(js, jnp.asarray(x)), new_ts
        _assert_state_equal(js, ts)
    assert ts["_update_count"].dtype == torch.int32 and int(ts["_update_count"]) == 4
    np.testing.assert_array_equal(tm.compute_from(ts).numpy(), np.asarray(jm.compute_from(js)))
    # the stateful shell was not touched by the functional calls
    assert tm.update_count == 0 and tm.seen == []


def test_merge_states_matches_jax():
    jm, tm = JaxProbe(), TorchProbe(device="cpu")
    b = _batches(seed=2)
    ja = jm.update_state(jm.update_state(jm.init_state(), jnp.asarray(b[0])), jnp.asarray(b[1]))
    jb = jm.update_state(jm.init_state(), jnp.asarray(b[2]))
    ta = tm.update_state(tm.update_state(tm.init_state(), torch.from_numpy(b[0])), torch.from_numpy(b[1]))
    tb = tm.update_state(tm.init_state(), torch.from_numpy(b[2]))
    merged_j, merged_t = jm.merge_states(ja, jb), tm.merge_states(ta, tb)
    assert merged_t["_update_count"].dtype == torch.int32
    _assert_state_equal(merged_j, merged_t)


def test_state_dict_round_trips_and_crosses_from_jax():
    jm, tm = JaxProbe(), TorchProbe(device="cpu")
    for x in _batches(seed=3):
        jm.update(jnp.asarray(x))
        tm.update(torch.from_numpy(x))
    sd = tm.state_dict()
    assert set(sd) == {"total", "peak", "seen"}  # persistent states only
    fresh = TorchProbe(device="cpu")
    fresh.load_state_dict(sd)
    for key in sd:
        _assert_state_equal({key: getattr(tm, key)}, {key: getattr(fresh, key)})
    # a JAX state_dict (numpy leaves) loads into the port with its dtypes
    from_jax = TorchProbe(device="cpu")
    from_jax.load_state_dict(jm.state_dict())
    for key in sd:
        _assert_state_equal({key: getattr(jm, key)}, {key: getattr(from_jax, key)})


def test_load_state_dict_is_strict():
    tm = TorchProbe(device="cpu")
    sd = tm.state_dict()
    with pytest.raises(KeyError, match="Missing key"):
        TorchProbe(device="cpu").load_state_dict({k: v for k, v in sd.items() if k != "total"})
    with pytest.raises(KeyError, match="Unexpected"):
        TorchProbe(device="cpu").load_state_dict({**sd, "totl": sd["total"]})
    TorchProbe(device="cpu").load_state_dict({k: v for k, v in sd.items() if k != "total"}, strict=False)


def test_update_while_synced_raises_and_clone_is_independent():
    tm = TorchProbe(device="cpu")
    tm.update(torch.ones(2, 3, dtype=torch.int32))
    twin = tm.clone()
    twin.update(torch.ones(2, 3, dtype=torch.int32))
    assert int(tm.total) == 6 and int(twin.total) == 12 and tm.update_count == 1
    tm._is_synced = True
    with pytest.raises(MetricsTPUUserError):
        tm.update(torch.ones(2, 3, dtype=torch.int32))
    with pytest.raises(MetricsTPUUserError):
        tm(torch.ones(2, 3, dtype=torch.int32))


def test_sync_with_a_custom_gather_reduces_like_two_ranks():
    """``dist_sync_fn`` sees each state (list states pre-concatenated) and its
    per-rank results are reduced by each state's ``dist_reduce_fx``."""
    tm = TorchProbe(device="cpu", distributed_available_fn=lambda: True, dist_sync_fn=lambda t, group=None: [t, t])
    tm.update(torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32))
    local = tm.compute()  # compute syncs, then restores the local state
    assert int(tm.total) == 21
    assert float(local[0]) == 42.0 and float(local[1]) == 4 + 5 + 6 and float(local[3]) == 2 * (1 + 4)


# ---------------------------------------------------------------------- the members added with the metric core


def test_compute_on_cpu_moves_list_states_to_the_host_after_each_update():
    tm = TorchProbe(device="cpu", compute_on_cpu=True)
    tm.update(torch.ones(2, 3, dtype=torch.int32))
    assert tm.compute_on_cpu and all(s.device.type == "cpu" for s in tm.seen)
    with pytest.raises(ValueError, match="compute_on_cpu"):
        TorchProbe(device="cpu", compute_on_cpu="yes")
    assert JaxProbe(compute_on_cpu=True).compute_on_cpu


def test_set_dtype_converts_float_states_only_and_the_dtype_methods_do_nothing():
    tm = TorchProbe(device="cpu")
    tm.update(torch.ones(2, 3, dtype=torch.int32))
    assert tm.set_dtype(torch.float64) is tm
    assert tm.avg.dtype == tm._defaults["avg"].dtype == torch.float64
    assert tm.total.dtype == tm.peak.dtype == torch.int32
    for method in (tm.float, tm.double, tm.half):
        assert method() is tm
    assert tm.type(torch.float16) is tm and tm.avg.dtype == torch.float64  # the JAX package's no-ops


def test_to_device_moves_states_and_defaults():
    tm = TorchProbe(device="cpu")
    tm.update(torch.ones(2, 3, dtype=torch.int32))
    assert tm.to_device("meta") is tm and tm.device == torch.device("meta")
    assert tm.total.device.type == tm._defaults["total"].device.type == "meta"
    assert all(s.device.type == "meta" for s in tm.seen)


def test_metric_state_filter_kwargs_and_update_signature_match_jax():
    jm, tm = JaxProbe(), TorchProbe(device="cpu")
    x = _batches(seed=5, n=1)[0]
    jm.update(jnp.asarray(x))
    tm.update(torch.from_numpy(x))
    assert list(tm.metric_state) == list(jm.metric_state) == ["total", "peak", "avg", "seen"]
    _assert_state_equal(jm.metric_state, tm.metric_state)
    assert tm._filter_kwargs(x=1, y=2) == jm._filter_kwargs(x=1, y=2) == {"x": 1}
    assert list(tm._update_signature.parameters) == list(jm._update_signature.parameters)


def test_nested_state_dict_and_persistent_reach_child_metrics():
    """A metric holding other metrics (a wrapper's base, a list of them) saves,
    loads and sets persistence through them, under ``"<attr>."`` keys."""

    class TorchHolder(TorchProbe):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.base = TorchProbe(**kwargs)
            self.more = [TorchProbe(**kwargs)]

    class JaxHolder(JaxProbe):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.base = JaxProbe(**kwargs)
            self.more = [JaxProbe(**kwargs)]

    jm, tm = JaxHolder(), TorchHolder(device="cpu")
    assert [n for n, _ in tm._child_metrics()] == [n for n, _ in jm._child_metrics()] == ["base", "more.0"]
    x = _batches(seed=6, n=1)[0]
    for m, conv in ((jm, jnp.asarray), (tm, torch.from_numpy)):
        m.update(conv(x))
        m.base.update(conv(x))
        m.more[0].update(conv(x + 1))
        m.persistent(False)
    assert not tm._any_persistent() and tm.state_dict() == {}
    tm.base.persistent(True)
    assert tm._any_persistent()
    jm.persistent(True)
    tm.persistent(True)
    jsd, tsd = jm.state_dict(), tm.state_dict()
    assert list(tsd) == list(jsd)
    _assert_state_equal(jsd, tsd)
    fresh = TorchHolder(device="cpu")
    fresh.persistent(True)
    fresh.load_state_dict(jsd)
    np.testing.assert_array_equal(fresh.more[0].compute().numpy(), np.asarray(jm.more[0].compute()))
    with pytest.raises(KeyError, match="Unexpected"):
        fresh.load_state_dict({**tsd, "base.nope": tsd["total"]})
    with pytest.raises(KeyError, match="Missing key base.total"):
        fresh.load_state_dict({k: v for k, v in tsd.items() if k != "base.total"})


def test_compute_batch_value_leaves_the_global_state_as_it_was():
    tm = TorchProbe(device="cpu")
    for x in _batches(seed=7):
        tm.update(torch.from_numpy(x))
    before = {k: getattr(tm, k) for k in tm._defaults}
    donor = TorchProbe(device="cpu")
    donor(torch.from_numpy(_batches(seed=8, n=1)[0]))
    got = tm._compute_batch_value(donor._batch_state)
    assert torch.equal(got, donor._forward_cache)
    assert all(getattr(tm, k) is v for k, v in before.items()) and tm.update_count == 4


@contextlib.contextmanager
def world_of_one():
    """A gloo process group of one rank in this process (torn down after)."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        yield torch.distributed.group.WORLD
    finally:
        torch.distributed.destroy_process_group()


def jax_in_one_device_mesh(fn, *args):
    """``fn(*args)`` inside ``shard_map`` over a one-device mesh axis ``dp``."""
    import jax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()[:1]), ("dp",))
    specs = jax.tree.map(lambda _: P(), args)
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=specs, out_specs=P(), check_rep=False))(*args)


def test_compute_from_with_an_axis_name_waits_for_the_comm_plane():
    """``compute_from(state, axis_name=...)`` syncs through the comm plane
    (``sync_state``: one collective a state over the group) before computing:
    in a world of one it equals the JAX package's ``compute_from(state,
    axis_name="dp")`` inside ``shard_map`` on one device, the synced state
    equals the JAX one, and a metric's own ``axis_name`` is the default."""
    tm, jm = TorchProbe(device="cpu"), JaxProbe()
    ts, js = tm.init_state(), jm.init_state()
    for x in _batches(seed=9):
        ts = tm.update_state(ts, torch.from_numpy(x))
        js = jm.update_state(js, jnp.asarray(x))
    want = jax_in_one_device_mesh(lambda s: jm.compute_from(s, axis_name="dp"), js)
    want_state = jax_in_one_device_mesh(lambda s: jm.sync_state(s, "dp"), js)
    with world_of_one() as group:
        got = tm.compute_from(ts, axis_name=group)
        got_state = tm.sync_state(ts, group)
        own = TorchProbe(device="cpu", axis_name=group).compute_from(ts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(own.numpy(), np.asarray(want))
    _assert_state_equal(want_state, got_state)
    assert ts["seen"] is not got_state["seen"] and len(got_state["seen"]) == 1


def test_hash_and_clone_keep_instances_apart():
    a, b = TorchProbe(device="cpu"), TorchProbe(device="cpu")
    assert hash(a) != hash(b) and len({a, b, a}) == 2
    twin = a.clone()
    assert hash(twin) != hash(a) and twin.seen is not a.seen


def test_plot_draws_a_value_and_a_series():
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from metrics_tpu_torch.classification import MulticlassConfusionMatrix, MulticlassPrecision
    from metrics_tpu_torch.utils.plot import plot_confusion_matrix

    m = MulticlassPrecision(3, average=None, device="cpu")
    m.update(torch.tensor([0, 1, 2, 2]), torch.tensor([0, 1, 1, 2]))
    fig, ax = m.plot()
    assert fig is not None and ax.get_ylabel() == "MulticlassPrecision"
    fig2, ax2 = m.plot([m.compute(), m.compute() / 2])
    assert ax2.get_xlabel() == "Step"
    cm = MulticlassConfusionMatrix(3, device="cpu")
    cm.update(torch.tensor([0, 1, 2, 2]), torch.tensor([0, 1, 1, 2]))
    fig3, _ = plot_confusion_matrix(cm.compute(), labels=["a", "b", "c"])
    with pytest.raises(ValueError, match="labels"):
        plot_confusion_matrix(cm.compute(), labels=["a"])
    plt.close("all")


def test_metric_op_times_update_compute_and_sync_only_while_obs_is_on():
    from metrics_tpu_torch import obs
    from metrics_tpu_torch.obs import instrument

    tm = TorchProbe(device="cpu", distributed_available_fn=lambda: True, dist_sync_fn=lambda t, group=None: [t])
    x = torch.ones(2, 3, dtype=torch.int32)
    tm.update(x)
    assert not hasattr(tm, "_obs_instance_label")  # nothing labelled, nothing timed while obs is off
    obs.enable()
    try:
        tm.update(x)
        tm.compute()
    finally:
        obs.disable()
    label = tm._obs_instance_label
    for op in ("update", "compute", "sync"):
        assert instrument.OP_SECONDS.count(op=op, metric="TorchProbe", instance=label) == 1, op
    assert "_obs_instance_label" not in tm.clone().__dict__  # a clone gets its own series
