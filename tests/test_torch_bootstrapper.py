"""The port's ``BootStrapper`` and the hand kernels' batching rules against the
JAX package's ``BootStrapper``, on the CPU.

The same seeded numpy batches go to both packages' wrappers with the same
seed. Both draw from numpy's PCG64 generator, so they resample the same rows:
the resampling helpers are equal, and so are the stacked states (the
``torch.func.vmap`` / ``jax.vmap`` path) and the copies' states (the Poisson
and fallback path), bit for bit on every count state. ``_use_vmap`` after an
update is the JAX package's for every base tested: the classification bases
on the pair count, the binned curve and the sketches stay stacked; list
states, an ``.item()`` and a boolean mask take the copies. The kernels'
custom ops are held against their wrappers under ``torch.func.vmap`` on the
CPU, where their rules run the plain versions once a copy.

Tolerances: counts exact; float sums of other orders within rtol 1e-5, atol
1e-6 (F1's divisions differ from JAX's in the last bit); ``mean``, ``std``
and ``quantile`` of the copies' values within rtol 1e-5, atol 1e-6
(``jnp.mean`` and ``jnp.std(ddof=1)`` are not torch's in the last bit).
"""

from copy import deepcopy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu_torch as T
from metrics_tpu.classification import BinaryAUROC as JBinaryAUROC
from metrics_tpu.classification import MulticlassAccuracy as JAccuracy
from metrics_tpu.classification import MulticlassConfusionMatrix as JConfMat
from metrics_tpu.classification import MulticlassF1Score as JF1
from metrics_tpu.metric import Metric as JMetric
from metrics_tpu.regression import SpearmanCorrCoef as JSpearman
from metrics_tpu.wrappers import bootstrapping as jax_bs
from metrics_tpu_torch.classification import BinaryAUROC as TBinaryAUROC
from metrics_tpu_torch.classification import MulticlassAccuracy as TAccuracy
from metrics_tpu_torch.classification import MulticlassConfusionMatrix as TConfMat
from metrics_tpu_torch.classification import MulticlassF1Score as TF1
from metrics_tpu_torch.kernels import _batched, binned_curve, cms_walk, confmat, scatter
from metrics_tpu_torch.kernels._build import KernelLaunchError
from metrics_tpu_torch.metric import Metric as TMetric
from metrics_tpu_torch.regression import SpearmanCorrCoef as TSpearman
from metrics_tpu_torch.wrappers import bootstrapping as torch_bs

CPU = {"device": "cpu"}
RTOL, ATOL = 1e-5, 1e-6
C = 5


def close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def exact(got, want):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


class _JItemSum(JMetric):
    """A float() of a traced value: jax.vmap raises TypeError."""

    def __init__(self):
        super().__init__()
        self.add_state("total", jnp.zeros(()), dist_reduce_fx="sum")

    def update(self, preds, target):
        if float(jnp.sum(preds)) >= -1e30:
            self.total = self.total + jnp.sum(preds)

    def compute(self):
        return self.total


class _TItemSum(TMetric):
    """``.item()`` under torch.func.vmap: RuntimeError."""

    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds, target):
        if float(torch.sum(preds)) >= -1e30:
            self.total = self.total + torch.sum(preds)

    def compute(self):
        return self.total


class _JMaskedSum(JMetric):
    def __init__(self):
        super().__init__()
        self.add_state("total", jnp.zeros(()), dist_reduce_fx="sum")

    def update(self, preds, target):
        self.total = self.total + jnp.sum(preds[target >= 2])

    def compute(self):
        return self.total


class _TMaskedSum(TMetric):
    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds, target):
        self.total = self.total + torch.sum(preds[target >= 2])

    def compute(self):
        return self.total


# name -> (JAX base, port base, batch kind); STACKED: the bases the JAX package keeps stacked
BASES = {
    "accuracy": (lambda: JAccuracy(C, average="micro"), lambda: TAccuracy(C, average="micro", **CPU), "labels"),
    "f1": (lambda: JF1(C), lambda: TF1(C, **CPU), "labels"),
    "confmat": (lambda: JConfMat(C), lambda: TConfMat(C, **CPU), "labels"),
    "auroc_binned": (lambda: JBinaryAUROC(thresholds=100), lambda: TBinaryAUROC(thresholds=100, **CPU), "scores"),
    "quantile": (lambda: J.QuantileSketch(), lambda: T.QuantileSketch(**CPU), "values"),
    "cardinality": (lambda: J.CardinalitySketch(), lambda: T.CardinalitySketch(**CPU), "ids"),
    "heavy_hitters": (lambda: J.HeavyHittersSketch(k=4, depth=2, width=64),
                      lambda: T.HeavyHittersSketch(k=4, depth=2, width=64, **CPU), "ids"),
    "auroc_exact": (lambda: JBinaryAUROC(), lambda: TBinaryAUROC(**CPU), "scores"),
    "spearman": (lambda: JSpearman(), lambda: TSpearman(**CPU), "pairs"),
    "item": (_JItemSum, _TItemSum, "floats"),
    "boolean_mask": (_JMaskedSum, _TMaskedSum, "floats"),
}
STACKED = ["accuracy", "f1", "confmat", "auroc_binned", "quantile", "cardinality", "heavy_hitters"]


def batch(kind, rng, n=48):
    if kind == "labels":
        return rng.integers(0, C, n), rng.integers(0, C, n)
    if kind == "scores":
        return rng.random(n).astype(np.float32), rng.integers(0, 2, n)
    if kind == "values":
        return (rng.normal(size=n).astype(np.float32),)
    if kind == "ids":
        return (rng.integers(0, 40, n).astype(np.int32),)
    if kind == "pairs":
        return rng.normal(size=n).astype(np.float32), rng.normal(size=n).astype(np.float32)
    return rng.normal(size=n).astype(np.float32), rng.integers(0, 4, n)


def twins(name, strategy="multinomial", n_boot=4, seed=3, **kw):
    jm, tm, kind = BASES[name]
    j = J.BootStrapper(jm(), num_bootstraps=n_boot, sampling_strategy=strategy, seed=seed, **kw)
    t = T.BootStrapper(tm(), num_bootstraps=n_boot, sampling_strategy=strategy, seed=seed, **kw)
    return j, t, kind


def feed(j, t, kind, updates=2, seed=0, n=48):
    rng = np.random.default_rng(seed)
    for _ in range(updates):
        arrays = batch(kind, rng, n)
        j.update(*[jnp.asarray(a) for a in arrays])
        t.update(*[torch.from_numpy(a) for a in arrays])


# ----------------------------------------------------------------- resampling


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
@pytest.mark.parametrize("size", [0, 1, 7, 1000])
def test_the_sampler_draws_the_jax_rows(strategy, size):
    a = jax_bs._bootstrap_sampler(size, strategy, np.random.default_rng(5))
    b = torch_bs._bootstrap_sampler(size, strategy, np.random.default_rng(5))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jax_bs._POISSON1_CDF, torch_bs._POISSON1_CDF)


def test_the_sampler_refuses_an_unknown_strategy():
    with pytest.raises(ValueError, match="Unknown sampling strategy"):
        torch_bs._bootstrap_sampler(4, "bogus")


@pytest.mark.parametrize("n", [0, 1, 5, 4095, 4096, 4097, 12345])
@pytest.mark.parametrize("chunkable", [True, False])
def test_chunk_spans_are_the_jax_spans(n, chunkable):
    assert torch_bs._chunk_spans(n, chunkable) == jax_bs._chunk_spans(n, chunkable)


# ----------------------------------------------------------------- the stacked path


@pytest.mark.parametrize("name", list(BASES))
def test_use_vmap_after_an_update_is_the_jax_packages(name):
    j, t, kind = twins(name)
    assert j._use_vmap == t._use_vmap
    feed(j, t, kind)
    assert t._use_vmap == j._use_vmap
    assert t._use_vmap == (name in STACKED)


@pytest.mark.parametrize("name", STACKED)
def test_stacked_states_equal_the_jax_packages(name):
    j, t, kind = twins(name)
    feed(j, t, kind, updates=3)
    assert sorted(t._stacked_state) == sorted(j._stacked_state)
    for key, want in j._stacked_state.items():
        got = t._stacked_state[key]
        if got.is_floating_point() and name not in ("auroc_binned",):
            close(got, want)
        else:
            exact(got, want)  # int32 counts, and the binned curve's 0/1-weighted float counts


@pytest.mark.parametrize("name", STACKED)
def test_stacked_states_equal_the_ports_copies(name):
    """The stacked path against the port's own copies path on the same seed:
    the same rows, each copy's state equal to its row bit for bit."""
    _, tm, kind = BASES[name]
    fast = T.BootStrapper(tm(), num_bootstraps=4, sampling_strategy="multinomial", seed=11)
    slow = T.BootStrapper(tm(), num_bootstraps=4, sampling_strategy="multinomial", seed=11)
    slow._use_vmap = False
    del slow._stacked_state
    slow.metrics = [deepcopy(slow.base_metric) for _ in range(4)]
    rng = np.random.default_rng(1)
    for _ in range(3):
        arrays = [torch.from_numpy(a) for a in batch(kind, rng)]
        fast.update(*arrays)
        slow.update(*arrays)
    assert fast._use_vmap
    for i, m in enumerate(slow.metrics):
        for key in m._defaults:
            assert torch.equal(fast._stacked_state[key][i], getattr(m, key)), (key, i)
        # a copy counts one update a chunk span (48 rows: 32 + 16), the stacked state one a batch
        assert int(fast._stacked_state["_update_count"][i]) == 3
        assert m._update_count == 3 * len(torch_bs._chunk_spans(48, True))


@pytest.mark.parametrize("name", STACKED)
@pytest.mark.parametrize("strategy", ["multinomial", "poisson"])
def test_compute_matches_jax(name, strategy):
    if name == "heavy_hitters":
        kw = {"raw": True, "mean": False, "std": False}
    else:
        kw = {"raw": True, "quantile": 0.9}
    j, t, kind = twins(name, strategy, n_boot=5, **kw)
    feed(j, t, kind)
    want, got = j.compute(), t.compute()
    assert sorted(got) == sorted(want)
    for key in want:
        if name == "heavy_hitters":
            exact(got[key], want[key])
        else:
            close(got[key], want[key])


@pytest.mark.parametrize("quantile", [0.05, np.array([0.1, 0.5, 0.9])], ids=["scalar", "array"])
def test_mean_std_and_quantiles_of_the_copies(quantile):
    j, t, kind = twins("accuracy", n_boot=7, quantile=quantile, raw=True)
    feed(j, t, kind, updates=3)
    want, got = j.compute(), t.compute()
    for key in ("mean", "std", "quantile", "raw"):
        close(got[key], want[key])


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
def test_poisson_copies_states_equal_the_jax_packages(strategy):
    """The copies path: each copy's chunked updates (``_chunk_spans``) give the
    JAX package's states and update counts."""
    j, t, kind = twins("confmat", strategy, n_boot=3)
    if strategy == "multinomial":
        j._use_vmap = t._use_vmap = False
        j.metrics = [deepcopy(j.base_metric) for _ in range(3)]
        t.metrics = [deepcopy(t.base_metric) for _ in range(3)]
    feed(j, t, kind, updates=2, n=5000)
    for jm, tm in zip(j.metrics, t.metrics):
        exact(tm.confmat, jm.confmat)
        assert int(tm._update_count) == int(jm._update_count)


@pytest.mark.parametrize("strategy", ["multinomial", "poisson"])
def test_forward_returns_the_batch_statistics_and_keeps_accumulating(strategy):
    j, t, kind = twins("accuracy", strategy, raw=True)
    rng = np.random.default_rng(7)
    for _ in range(3):
        arrays = batch(kind, rng)
        want = j(*[jnp.asarray(a) for a in arrays])
        got = t(*[torch.from_numpy(a) for a in arrays])
        for key in want:
            close(got[key], want[key])
    for key, want in j.compute().items():
        close(t.compute()[key], want)


def test_reset_clears_the_stacked_state_and_the_copies():
    for strategy in ("multinomial", "poisson"):
        j, t, kind = twins("confmat", strategy)
        feed(j, t, kind)
        t.reset()
        j.reset()
        feed(j, t, kind, seed=9)
        close(t.compute()["mean"], j.compute()["mean"])


@pytest.mark.parametrize("dtype", [np.float64, np.float16, np.int32, np.int64])
def test_regression_base_with_other_input_dtypes(dtype):
    """MSE's stacked float32 sums under float64, float16 and integer inputs
    (the JAX package sees float64 as float32, ROADMAP C.8)."""
    j = J.BootStrapper(J.MeanSquaredError(), num_bootstraps=4, sampling_strategy="multinomial", seed=2, raw=True)
    t = T.BootStrapper(T.MeanSquaredError(**CPU), num_bootstraps=4, sampling_strategy="multinomial", seed=2, raw=True)
    rng = np.random.default_rng(4)
    for _ in range(2):
        p, y = (rng.normal(size=32) * 4).astype(dtype), (rng.normal(size=32) * 4).astype(dtype)
        j.update(jnp.asarray(p), jnp.asarray(y))
        t.update(torch.from_numpy(p), torch.from_numpy(y))
    assert t._use_vmap and j._use_vmap
    for key, want in j._stacked_state.items():
        assert str(t._stacked_state[key].dtype).replace("torch.", "") == str(np.asarray(want).dtype)
        close(t._stacked_state[key], want, rtol=1e-3 if dtype == np.float16 else RTOL)
    close(t.compute()["raw"], j.compute()["raw"], rtol=1e-3 if dtype == np.float16 else RTOL)


# ----------------------------------------------------------------- the fallback


@pytest.mark.parametrize("name", ["item", "boolean_mask"])
def test_an_update_torch_cannot_vmap_falls_back_for_good(name):
    j, t, kind = twins(name)
    feed(j, t, kind)
    assert not t._use_vmap and not j._use_vmap
    assert len(t.metrics) == 4 and not hasattr(t, "_stacked_state")
    for jm, tm in zip(j.metrics, t.metrics):
        close(tm.total, jm.total)
    close(t.compute()["mean"], j.compute()["mean"])


def test_a_genuine_error_is_raised_by_the_loop_not_hidden():
    class Broken(TMetric):
        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

        def update(self, x):
            raise RuntimeError("a genuine fault")

        def compute(self):
            return self.total

    t = T.BootStrapper(Broken(), num_bootstraps=2, sampling_strategy="multinomial", seed=0)
    with pytest.raises(RuntimeError, match="a genuine fault"):
        t.update(torch.ones(4))
    assert not t._use_vmap


def test_a_kernel_launch_failure_is_raised_not_taken_for_a_fallback():
    class KernelFails(TMetric):
        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

        def update(self, x):
            raise KernelLaunchError("pair_count CUDA kernel failed to launch: too many resources (error 7)")

        def compute(self):
            return self.total

    t = T.BootStrapper(KernelFails(), num_bootstraps=2, sampling_strategy="multinomial", seed=0)
    with pytest.raises(KernelLaunchError):
        t.update(torch.ones(4))
    assert t._use_vmap and hasattr(t, "_stacked_state")


def test_value_checks_are_skipped_on_the_stacked_path_as_under_a_trace():
    """An out-of-range label passes the stacked update (as under ``jax.vmap``,
    where the JAX package's checks cannot read values) and fails the copies'
    eager update in both packages."""
    labels = np.array([0, 1, 2, C + 3])
    j, t, _ = twins("accuracy")
    j.update(jnp.asarray(labels), jnp.asarray(labels % C))
    t.update(torch.from_numpy(labels), torch.from_numpy(labels % C))
    assert j._use_vmap and t._use_vmap
    exact(t._stacked_state["tp"], j._stacked_state["tp"])
    jp, tp_, _ = twins("accuracy", "poisson")
    with pytest.raises(RuntimeError):
        jp.update(jnp.asarray(labels), jnp.asarray(labels % C))
    with pytest.raises(RuntimeError):
        tp_.update(torch.from_numpy(labels), torch.from_numpy(labels % C))


# ----------------------------------------------------------------- errors and state


def test_bad_arguments_raise_the_jax_errors():
    with pytest.raises(ValueError, match="sampling_strategy"):
        T.BootStrapper(TAccuracy(C, **CPU), sampling_strategy="bogus")
    with pytest.raises(ValueError, match="Expected base metric"):
        T.BootStrapper("not a metric")
    t = T.BootStrapper(TAccuracy(C, **CPU), sampling_strategy="multinomial")
    with pytest.raises(ValueError, match="None of the input contained tensors"):
        t.update(1.0, 2.0)


@pytest.mark.parametrize("strategy", ["multinomial", "poisson"])
def test_state_dict_keys_and_leaves_are_the_jax_packages(strategy):
    j, t, kind = twins("accuracy", strategy)
    feed(j, t, kind)
    j.persistent(True)
    t.persistent(True)
    want, got = j.state_dict(), t.state_dict()
    assert sorted(got) == sorted(want)
    for key in ("_use_vmap", "_num_bootstraps", "_sampling_strategy", "_rng_state"):
        assert isinstance(got[key], np.ndarray) and got[key].dtype == np.asarray(want[key]).dtype
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    for key in want:
        if isinstance(got[key], torch.Tensor):
            exact(got[key], want[key]) if not got[key].is_floating_point() else close(got[key], want[key])


@pytest.mark.parametrize("strategy", ["multinomial", "poisson"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_dicts_cross_read_and_resume_alike(strategy, direction):
    """A state dict of one package loads into a fresh instance of the other;
    the generator's state comes with it, so both resume with the same draws."""
    j, t, kind = twins("confmat", strategy)
    feed(j, t, kind)
    j.persistent(True)
    t.persistent(True)
    j2 = J.BootStrapper(JConfMat(C), num_bootstraps=4, sampling_strategy=strategy)
    t2 = T.BootStrapper(TConfMat(C, **CPU), num_bootstraps=4, sampling_strategy=strategy)
    j2.persistent(True)
    t2.persistent(True)
    if direction == "jax_to_port":
        t2.load_state_dict({k: np.asarray(v) if not isinstance(v, list) else v for k, v in j.state_dict().items()})
        j2 = j
    else:
        j2.load_state_dict({k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in t.state_dict().items()})
        t2 = t
    feed(j2, t2, kind, seed=5)
    close(t2.compute()["mean"], j2.compute()["mean"])


def test_a_snapshot_of_another_configuration_is_refused():
    t = T.BootStrapper(TConfMat(C, **CPU), num_bootstraps=4, sampling_strategy="multinomial", seed=0)
    t.persistent(True)
    sd = t.state_dict()
    with pytest.raises(ValueError, match="num_bootstraps=4"):
        other = T.BootStrapper(TConfMat(C, **CPU), num_bootstraps=3, sampling_strategy="multinomial")
        other.persistent(True)
        other.load_state_dict(sd)
    with pytest.raises(ValueError, match="sampling_strategy='multinomial'"):
        other = T.BootStrapper(TConfMat(C, **CPU), num_bootstraps=4, sampling_strategy="poisson")
        other.persistent(True)
        other.load_state_dict(sd)


def test_a_copies_snapshot_reshapes_a_stacked_instance():
    j, t, kind = twins("item")
    feed(j, t, kind)
    t.persistent(True)
    fresh = T.BootStrapper(_TItemSum(), num_bootstraps=4, sampling_strategy="multinomial")
    fresh.persistent(True)
    assert fresh._use_vmap
    fresh.load_state_dict(t.state_dict())
    assert not fresh._use_vmap and len(fresh.metrics) == 4
    close(fresh.compute()["mean"], j.compute()["mean"])


def test_to_device_and_set_dtype_move_the_wrapper_state():
    t = T.BootStrapper(T.MeanSquaredError(**CPU), num_bootstraps=3, sampling_strategy="multinomial", seed=0)
    t.update(torch.ones(4), torch.zeros(4))
    t.to_device("cpu").set_dtype(torch.float64)
    assert t._stacked_state["sum_squared_error"].dtype == torch.float64
    assert all(v.device.type == "cpu" for v in t._stacked_state.values())
    assert t._stacked_state["_update_count"].dtype == torch.int32


# ----------------------------------------------------------------- the kernels' batching rules


def _labels(rng, b, n, c=C, dtype=np.int64):
    return torch.from_numpy(rng.integers(-1, c + 1, (b, n)).astype(dtype))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_the_pair_count_rules_run_the_wrapper_once_a_copy(dtype):
    rng = np.random.default_rng(0)
    r, c = _labels(rng, 3, 50, dtype=dtype), _labels(rng, 3, 50, dtype=dtype)
    mask = torch.from_numpy(rng.random((3, 50)) < 0.7)
    for ignore in (None, 2):
        got = torch.func.vmap(lambda a, b, m: confmat.pair_count(a, b, C, C + 1, m, ignore))(r, c, mask)
        for i in range(3):
            assert torch.equal(got[i], confmat.pair_count_bincount(r[i], c[i], C, C + 1, mask[i], ignore))
        tp, fp, tn, fn = torch.func.vmap(lambda a, b: confmat.stat_scores(a, b, C, ignore))(r, c)
        for i in range(3):
            want = confmat.stat_scores_bincount(r[i], c[i], C, ignore)
            assert all(torch.equal(g[i], w) for g, w in zip((tp, fp, tn, fn), want))
    # one side unbatched (in_dims None)
    got = torch.func.vmap(lambda a: confmat.pair_count(a, c[0], C, C))(r)
    assert all(torch.equal(got[i], confmat.pair_count_bincount(r[i], c[0], C, C)) for i in range(3))


def test_the_binned_curve_rule_runs_the_wrapper_once_a_copy():
    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.random((4, 200)).astype(np.float32))
    tw = torch.from_numpy((rng.random((4, 200)) < 0.4).astype(np.float32))
    w = torch.ones(4, 200)
    thr = torch.linspace(0, 1, 17)
    tp, fp = torch.func.vmap(binned_curve.binned_curve_counts, in_dims=(0, 0, 0, None))(p, tw, w, thr)
    for i in range(4):
        want = binned_curve.reference_counts(p[i], tw[i], w[i], thr)
        assert torch.equal(tp[i], want[0]) and torch.equal(fp[i], want[1])
    p2 = torch.from_numpy(rng.random((2, 100, 3)).astype(np.float32))
    tw2 = (p2 > 0.5).to(torch.float32)
    tp, fp = torch.func.vmap(binned_curve.binned_curve_counts, in_dims=(0, 0, None, None))(p2, tw2, torch.ones(100), thr)
    assert tp.shape == (2, 17, 3)
    assert torch.equal(tp[1], binned_curve.reference_counts(p2[1], tw2[1], torch.ones(100), thr)[0])


@pytest.mark.parametrize("kernel", ["hist_add", "hist_max"])
def test_the_scatter_rules_run_the_wrapper_once_a_copy(kernel):
    rng = np.random.default_rng(2)
    bins = torch.from_numpy(rng.integers(0, 9, (3, 16)).astype(np.int32))
    idx = torch.from_numpy(rng.integers(-2, 18, (3, 40)).astype(np.int32))
    val = torch.from_numpy(rng.integers(0, 30, (3, 40)).astype(np.int32))
    wrapper = scatter.hist_add_cuda if kernel == "hist_add" else scatter.hist_max_cuda
    ref = scatter.hist_add_reference if kernel == "hist_add" else scatter.hist_max_reference
    entry = "ddsketch_hist_add" if kernel == "hist_add" else "hll_scatter_max"
    for fn in (wrapper, lambda b, i, v: T.kernels.dispatch(entry, b, i, v)):
        got = torch.func.vmap(fn)(bins, idx, val)
        assert all(torch.equal(got[i], ref(bins[i], idx[i], val[i])) for i in range(3))


def test_the_count_min_rules_run_the_wrapper_once_a_copy():
    rng = np.random.default_rng(3)
    counts = torch.from_numpy(rng.integers(0, 5, (3, 4, 32)).astype(np.int32))
    ids = torch.from_numpy(rng.integers(-3, 100, (3, 64)).astype(np.int32))
    got = torch.func.vmap(scatter.cms_ids_add_cuda)(counts, ids)
    assert all(torch.equal(got[i], scatter.cms_ids_add_reference(counts[i], ids[i])) for i in range(3))
    cols = torch.from_numpy(rng.integers(-1, 33, (3, 64, 4)).astype(np.int32))
    valid = ids >= 0
    got = torch.func.vmap(scatter.cms_rows_add_cuda)(counts, cols, valid)
    assert all(torch.equal(got[i], scatter.cms_rows_add_reference(counts[i], cols[i], valid[i])) for i in range(3))
    ledger = torch.tensor([[-1, 0]] * 5, dtype=torch.int32).expand(3, 5, 2).contiguous()
    c2, l2 = torch.func.vmap(cms_walk.cms_walk_cuda)(counts, ledger, ids)
    for i in range(3):
        want = cms_walk.cms_walk_reference(counts[i], ledger[i], ids[i])
        assert torch.equal(c2[i], want[0]) and torch.equal(l2[i], want[1])
    with pytest.raises(ValueError, match="counters"):
        torch.func.vmap(lambda c, l, i: cms_walk.cms_walk_cuda(c, l, i, torch.zeros(3, dtype=torch.int64)))(
            counts, ledger, ids)


def test_nested_vmap_reaches_the_rule_at_each_level():
    rng = np.random.default_rng(4)
    r = torch.from_numpy(rng.integers(0, C, (2, 3, 30)))
    c = torch.from_numpy(rng.integers(0, C, (2, 3, 30)))
    got = torch.func.vmap(torch.func.vmap(lambda a, b: confmat.pair_count(a, b, C, C)))(r, c)
    assert got.shape == (2, 3, C, C)
    assert torch.equal(got[1, 2], confmat.pair_count_bincount(r[1, 2], c[1, 2], C, C))


def test_an_unbatched_call_never_reaches_an_op(monkeypatch):
    """The direct route stays as it was: no custom op, no batching check past
    one C call when no transform is active."""
    called = []
    monkeypatch.setattr(confmat, "_stat_scores_op", lambda *a: called.append(a))
    monkeypatch.setattr(confmat, "_pair_count_op", lambda *a: called.append(a))
    t = torch.tensor([0, 1, 2])
    confmat.stat_scores(t, t, C)
    confmat.pair_count(t, t, C, C)
    assert called == [] and not _batched.is_batched(t)


def test_the_ops_have_fake_implementations():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        r = torch.empty(10, dtype=torch.int64)
        assert confmat._pair_count_op(r, r, 3, 4, None, None).shape == (3, 4)
        assert confmat._stat_scores_op(r, r, 6, None).shape == (4, 6)
        b = torch.empty(16, dtype=torch.int32)
        i = torch.empty(10, dtype=torch.int32)
        assert scatter._hist_add_op(b, i, i).shape == (16,)
        assert scatter._hist_max_op(b, i, i).shape == (16,)
        t = torch.empty(4, 32, dtype=torch.int32)
        assert scatter._cms_ids_add_op(t, i).shape == (4, 32)
        assert scatter._cms_rows_add_op(t, torch.empty(10, 4, dtype=torch.int32), i).shape == (4, 32)
        led = torch.empty(5, 2, dtype=torch.int32)
        assert [x.shape for x in cms_walk._cms_walk_op(t, led, i)] == [(4, 32), (5, 2)]
        p = torch.empty(10, dtype=torch.float32)
        assert [x.shape for x in binned_curve._binned_curve_op(p, p, p, torch.empty(7))] == [(7,), (7,)]


def test_the_op_bodies_are_the_wrappers():
    rng = np.random.default_rng(5)
    r = torch.from_numpy(rng.integers(0, C, 40))
    c = torch.from_numpy(rng.integers(0, C, 40))
    assert torch.equal(confmat._pair_count_op(r, c, C, C, None, None), confmat.pair_count_bincount(r, c, C, C))
    assert torch.equal(confmat._stat_scores_op(r, c, C, None), torch.stack(confmat.stat_scores_bincount(r, c, C)))
