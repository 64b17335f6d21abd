"""The port's ``ClasswiseWrapper``, ``MinMaxMetric``, ``MultioutputWrapper`` and
``MetricTracker``, and the ``utils`` remainder, against the JAX package's, on
the CPU.

The same seeded numpy batches go through both packages (``update``,
``forward``, ``compute``, ``reset``, state dicts, errors). Tolerances: values
within rtol 1e-5, atol 1e-6 (float32 in another order); the trackers' best
steps exact; errors of the JAX package's types.
"""

import doctest
import importlib
import logging
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu.utils as jax_utils
import metrics_tpu_torch as T
import metrics_tpu_torch.utils as torch_utils
from metrics_tpu.classification import MulticlassAccuracy as JAccuracy
from metrics_tpu.classification import MulticlassF1Score as JF1
from metrics_tpu.classification import MulticlassPrecision as JPrecision
from metrics_tpu.classification import MulticlassRecall as JRecall
from metrics_tpu.wrappers import multioutput as jax_mo
from metrics_tpu_torch.classification import MulticlassAccuracy as TAccuracy
from metrics_tpu_torch.classification import MulticlassF1Score as TF1
from metrics_tpu_torch.classification import MulticlassPrecision as TPrecision
from metrics_tpu_torch.classification import MulticlassRecall as TRecall
from metrics_tpu_torch.utils.checks import traced
from metrics_tpu_torch.wrappers import multioutput as torch_mo

CPU = {"device": "cpu"}
RTOL, ATOL = 1e-5, 1e-6
C = 5


def close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            close(got[k], want[k], rtol, atol)
        return
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def labels(seed, n=64, c=C):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, c)).astype(np.float32), rng.integers(0, c, n)


def both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ----------------------------------------------------------------- ClasswiseWrapper


@pytest.mark.parametrize("labels_arg", [None, ["a", "b", "c", "d", "e"]])
def test_classwise_keys_and_values_match_jax(labels_arg):
    j = J.ClasswiseWrapper(JAccuracy(C, average=None), labels=labels_arg)
    t = T.ClasswiseWrapper(TAccuracy(C, average=None, **CPU), labels=labels_arg)
    for seed in range(3):
        (jp, jt), (tp, tt) = both(*labels(seed))
        close(t(tp, tt), j(jp, jt))
    close(t.compute(), j.compute())
    t.reset()
    j.reset()
    (jp, jt), (tp, tt) = both(*labels(7))
    t.update(tp, tt)
    j.update(jp, jt)
    close(t.compute(), j.compute())


def test_classwise_inside_a_collection():
    p, y = np.array([0, 1, 2, 1, 0, 2]), np.array([0, 1, 1, 1, 0, 2])
    jc = J.MetricCollection({"cw_acc": J.ClasswiseWrapper(JAccuracy(3, average=None)),
                             "prec": JPrecision(3, average="macro")})
    tc = T.MetricCollection({"cw_acc": T.ClasswiseWrapper(TAccuracy(3, average=None, **CPU)),
                             "prec": TPrecision(3, average="macro", **CPU)})
    (jp, jy), (tp, ty) = both(p, y)
    jc.update(jp, jy)
    tc.update(tp, ty)
    out = tc.compute()
    assert set(out) == {"multiclassaccuracy_0", "multiclassaccuracy_1", "multiclassaccuracy_2", "prec"}
    close(out, jc.compute())
    close(tc(tp, ty), jc(jp, jy))


def test_classwise_errors():
    with pytest.raises(ValueError, match="instance of `metrics_tpu.Metric`"):
        T.ClasswiseWrapper("x")
    with pytest.raises(ValueError, match="list of strings"):
        T.ClasswiseWrapper(TAccuracy(C, average=None, **CPU), labels=[1, 2])


# ----------------------------------------------------------------- MinMaxMetric


def test_minmax_over_forwards_and_updates_matches_jax():
    j = J.MinMaxMetric(JF1(C))
    t = T.MinMaxMetric(TF1(C, **CPU))
    for seed in range(4):
        (jp, jt), (tp, tt) = both(*labels(seed, n=32))
        close(t(tp, tt), j(jp, jt))
    close(t.compute(), j.compute())
    for seed in range(4, 6):
        (jp, jt), (tp, tt) = both(*labels(seed, n=32))
        t.update(tp, tt)
        j.update(jp, jt)
        close(t.compute(), j.compute())
    assert t.min_val.dtype == t.max_val.dtype == torch.float32
    assert "min_val" not in t._defaults and "max_val" not in t._defaults


def test_minmax_reset_keeps_the_extremes_as_the_reference_does():
    j = J.MinMaxMetric(J.MeanMetric())
    t = T.MinMaxMetric(T.MeanMetric(**CPU))
    for v in (2.0, 4.0):
        j.update(jnp.asarray(v))
        t.update(torch.tensor(v))
        close(t.compute(), j.compute())
    j.reset()
    t.reset()
    j.update(jnp.asarray(1.0))
    t.update(torch.tensor(1.0))
    close(t.compute(), j.compute())
    assert float(t.max_val) == 3.0 and float(t.min_val) == 1.0


@pytest.mark.parametrize("value", [2, 2.5])
def test_minmax_of_python_scalars(value):
    class Const(T.MeanMetric):
        def compute(self):
            return value

    class JConst(J.MeanMetric):
        def compute(self):
            return value

    j, t = J.MinMaxMetric(JConst()), T.MinMaxMetric(Const(**CPU))
    want, got = j.compute(), t.compute()
    assert str(got["raw"].dtype).replace("torch.", "") == str(np.asarray(want["raw"]).dtype)
    close(got, want)


def test_minmax_refuses_non_scalars_and_non_metrics():
    with pytest.raises(ValueError, match="Expected base metric"):
        T.MinMaxMetric(1.0)
    t = T.MinMaxMetric(TAccuracy(C, average=None, **CPU))
    t.update(torch.tensor([0, 1]), torch.tensor([0, 1]))
    with pytest.raises(RuntimeError, match="float or scalar tensor"):
        t.compute()


def test_minmax_state_dict_carries_the_extremes_both_ways():
    j = J.MinMaxMetric(JAccuracy(C, average="micro"))
    t = T.MinMaxMetric(TAccuracy(C, average="micro", **CPU))
    for seed in range(2):
        (jp, jt), (tp, tt) = both(*labels(seed))
        j.update(jp, jt)
        t.update(tp, tt)
        j.compute()
        t.compute()
    j.persistent(True)
    t.persistent(True)
    sd_j, sd_t = j.state_dict(), t.state_dict()
    assert sorted(sd_j) == sorted(sd_t)
    t2 = T.MinMaxMetric(TAccuracy(C, average="micro", **CPU))
    t2.persistent(True)
    t2.load_state_dict({k: np.asarray(v) for k, v in sd_j.items()})
    close(t2.compute(), j.compute())
    j2 = J.MinMaxMetric(JAccuracy(C, average="micro"))
    j2.persistent(True)
    j2.load_state_dict({k: v.numpy() for k, v in sd_t.items()})
    close(t.compute(), j2.compute())


# ----------------------------------------------------------------- MultioutputWrapper


def _regression_batch(seed, n=40, outputs=3, nan_rows=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, outputs)).astype(dtype)
    y = rng.normal(size=(n, outputs)).astype(dtype)
    if nan_rows:
        rows = rng.choice(n, nan_rows, replace=False)
        p[rows, rng.integers(0, outputs, nan_rows)] = np.nan
    return p, y


@pytest.mark.parametrize("remove_nans", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16])
def test_multioutput_matches_jax(remove_nans, dtype):
    j = J.MultioutputWrapper(J.MeanSquaredError(), 3, remove_nans=remove_nans)
    t = T.MultioutputWrapper(T.MeanSquaredError(**CPU), 3, remove_nans=remove_nans)
    rtol = 1e-2 if dtype == np.float16 else RTOL
    for seed in range(3):
        (jp, jy), (tp, ty) = both(*_regression_batch(seed, nan_rows=4, dtype=dtype))
        close(t(tp, ty), j(jp, jy), rtol=rtol)
    got, want = t.compute(), j.compute()
    assert np.isnan(np.asarray(want)).any() != remove_nans
    close(got, want, rtol=rtol)
    t.reset()
    j.reset()
    (jp, jy), (tp, ty) = both(*_regression_batch(5))
    t.update(tp, ty)
    j.update(jp, jy)
    close(t.compute(), j.compute())


def test_multioutput_along_dim_0_without_squeeze():
    j = J.MultioutputWrapper(J.MeanAbsoluteError(), 2, output_dim=0, squeeze_outputs=False)
    t = T.MultioutputWrapper(T.MeanAbsoluteError(**CPU), 2, output_dim=0, squeeze_outputs=False)
    (jp, jy), (tp, ty) = both(*_regression_batch(1, n=2, outputs=30))
    j.update(jp, jy)
    t.update(tp, ty)
    close(t.compute(), j.compute())


def test_multioutput_skips_the_nan_rows_under_a_trace():
    """Dropping rows reads values, so it is skipped where the JAX package's
    trace skips it (ROADMAP C.4): the NaN reaches the base metric."""
    t = T.MultioutputWrapper(T.MeanSquaredError(**CPU), 2)
    p, y = _regression_batch(0, outputs=2, nan_rows=1)
    with traced():
        t.update(torch.from_numpy(p), torch.from_numpy(y))
    assert torch.isnan(t.compute()).any()


def test_multioutput_forward_returns_none_when_a_copy_does():
    class NoneForward(T.MeanSquaredError):
        def forward(self, *args, **kwargs):
            self.update(*args, **kwargs)

    t = T.MultioutputWrapper(NoneForward(**CPU), 2)
    p, y = _regression_batch(0, outputs=2)
    assert t(torch.from_numpy(p), torch.from_numpy(y)) is None


def test_get_nan_indices_matches_jax():
    p, y = _regression_batch(3, n=20, outputs=4, nan_rows=5)
    (jp, jy), (tp, ty) = both(p, y)
    np.testing.assert_array_equal(torch_mo._get_nan_indices(tp, ty).numpy(), np.asarray(jax_mo._get_nan_indices(jp, jy)))
    with pytest.raises(ValueError, match="at least one tensor"):
        torch_mo._get_nan_indices()


# ----------------------------------------------------------------- MetricTracker


def _tracker_run(cls_j, cls_t, maximize, epochs=3):
    jt, tt = J.MetricTracker(cls_j(), maximize=maximize), T.MetricTracker(cls_t(), maximize=maximize)
    for epoch in range(epochs):
        jt.increment()
        tt.increment()
        for seed in range(2):
            (jp, jy), (tp, ty) = both(*labels(10 * epoch + seed))
            jt.update(jp, jy)
            tt.update(tp, ty)
        close(tt.compute(), jt.compute())
    return jt, tt


@pytest.mark.parametrize("maximize", [True, False])
def test_tracker_tracks_steps_and_the_best_as_jax(maximize):
    jt, tt = _tracker_run(lambda: JAccuracy(C, average="micro"), lambda: TAccuracy(C, average="micro", **CPU),
                          maximize)
    close(tt.compute_all(), jt.compute_all())
    assert tt.n_steps == jt.n_steps == len(tt) == 3
    best_j, step_j = jt.best_metric(return_step=True)
    best_t, step_t = tt.best_metric(return_step=True)
    assert step_t == step_j and best_t == pytest.approx(best_j, rel=1e-6)
    assert tt.best_metric() == pytest.approx(jt.best_metric(), rel=1e-6)


def test_tracker_over_a_collection_with_a_maximize_list():
    def cols(pkg):
        acc, rec = (JAccuracy, JRecall) if pkg == "j" else (TAccuracy, TRecall)
        kw = {} if pkg == "j" else CPU
        return (J if pkg == "j" else T).MetricCollection(
            {"acc": acc(C, average="micro", **kw), "rec": rec(C, average="macro", **kw)})

    jt, tt = _tracker_run(lambda: cols("j"), lambda: cols("t"), [True, False])
    close(tt.compute_all(), jt.compute_all())
    bj, sj = jt.best_metric(return_step=True)
    bt, st = tt.best_metric(return_step=True)
    assert st == sj and bt == pytest.approx(bj, rel=1e-6)


def test_tracker_best_of_a_non_scalar_is_none_with_a_warning():
    tt = T.MetricTracker(TAccuracy(C, average=None, **CPU))
    jt = J.MetricTracker(JAccuracy(C, average=None))
    y = np.arange(20) % C  # perfect predictions: every class's accuracy is 1, argmax 0, a row, not a float
    for _ in range(2):
        for t in (tt, jt):
            t.increment()
        tt.update(torch.from_numpy(y), torch.from_numpy(y))
        jt.update(jnp.asarray(y), jnp.asarray(y))
    with pytest.warns(UserWarning, match="best metric"):
        assert tt.best_metric(return_step=True) == (None, None) == jt.best_metric(return_step=True)


def test_tracker_errors_are_the_jax_errors():
    with pytest.raises(TypeError, match="Metric arg need to be an instance"):
        T.MetricTracker([1, 2])
    with pytest.raises(ValueError, match="single bool or list of bool"):
        T.MetricTracker(TAccuracy(C, **CPU), maximize=1)
    with pytest.raises(ValueError, match="single bool when"):
        T.MetricTracker(TAccuracy(C, **CPU), maximize=[True])
    with pytest.raises(ValueError, match="should match the length"):
        T.MetricTracker(T.MetricCollection([TAccuracy(C, **CPU)]), maximize=[True, False])
    tr = T.MetricTracker(TAccuracy(C, **CPU))
    for call in (lambda: tr.update(torch.tensor([0]), torch.tensor([0])), tr.compute, tr.compute_all,
                 lambda: tr(torch.tensor([0]), torch.tensor([0]))):
        with pytest.raises(ValueError, match="cannot be called before"):
            call()


def test_tracker_state_dict_grows_and_truncates_the_history_both_ways():
    jt, tt = _tracker_run(lambda: JAccuracy(C, average="micro"), lambda: TAccuracy(C, average="micro", **CPU), True)
    jt.persistent(True)
    tt.persistent(True)
    sd_j, sd_t = jt.state_dict(), tt.state_dict()
    assert sorted(sd_j) == sorted(sd_t)
    fresh = T.MetricTracker(TAccuracy(C, average="micro", **CPU))
    fresh.persistent(True)
    fresh.load_state_dict({k: np.asarray(v) for k, v in sd_j.items()})
    assert fresh.n_steps == 3
    close(fresh.compute_all(), jt.compute_all())
    for _ in range(2):
        tt.increment()
    tt.load_state_dict(sd_t)
    assert tt.n_steps == 3
    jfresh = J.MetricTracker(JAccuracy(C, average="micro"))
    jfresh.persistent(True)
    jfresh.load_state_dict({k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in sd_t.items()})
    close(tt.compute_all(), jfresh.compute_all())
    with pytest.raises(KeyError, match="_n_steps"):
        T.MetricTracker(TAccuracy(C, **CPU)).load_state_dict({})


def test_tracker_forward_reset_and_pickle():
    tt = T.MetricTracker(T.MeanMetric(**CPU))
    jt = J.MetricTracker(J.MeanMetric())
    for tr in (tt, jt):
        tr.increment()
    close(tt(torch.tensor(2.0)), jt(jnp.asarray(2.0)))
    tt.reset()
    jt.reset()
    tt.update(torch.tensor(5.0))
    jt.update(jnp.asarray(5.0))
    tt.increment()
    jt.increment()
    tt.update(torch.tensor(1.0))
    jt.update(jnp.asarray(1.0))
    tt2 = pickle.loads(pickle.dumps(tt))
    close(tt2.compute_all(), jt.compute_all())
    tt.reset_all()
    assert tt[0]._update_count == 0 and tt[1]._update_count == 0


# ----------------------------------------------------------------- wrappers on a device


@pytest.mark.parametrize("make", [
    lambda: T.BootStrapper(TAccuracy(C, average="micro", **CPU), 3, sampling_strategy="multinomial"),
    lambda: T.BootStrapper(TAccuracy(C, average="micro", **CPU), 3),
    lambda: T.ClasswiseWrapper(TAccuracy(C, average=None, **CPU)),
    lambda: T.MinMaxMetric(TAccuracy(C, average="micro", **CPU)),
    lambda: T.MultioutputWrapper(T.MeanSquaredError(**CPU), 2),
], ids=["bootstrap_stacked", "bootstrap_copies", "classwise", "minmax", "multioutput"])
def test_each_wrapper_lives_on_its_base_metrics_device_and_moves_with_to_device(make):
    w = make()
    assert w.device.type == "cpu"
    w.to_device("meta")
    held = [w.device]
    for m in (getattr(w, "metric", None), getattr(w, "_base_metric", None), getattr(w, "base_metric", None),
              *getattr(w, "metrics", [])):
        if m is not None:
            held += [m.device] + [getattr(m, s).device for s in m._defaults if not isinstance(getattr(m, s), list)]
    held += [v.device for v in getattr(w, "_stacked_state", {}).values()]
    held += [getattr(w, a).device for a in ("min_val", "max_val") if hasattr(w, a)]
    assert all(d.type == "meta" for d in held), held


# ----------------------------------------------------------------- utils remainder


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none", None])
def test_reduce_matches_jax(reduction):
    x = np.random.default_rng(0).normal(size=(4, 5)).astype(np.float32)
    close(torch_utils.reduce(torch.from_numpy(x), reduction), jax_utils.reduce(jnp.asarray(x), reduction))


@pytest.mark.parametrize("class_reduction", ["micro", "macro", "weighted", "none", None])
def test_class_reduce_matches_jax(class_reduction):
    rng = np.random.default_rng(1)
    num = rng.integers(0, 5, 6).astype(np.float32)
    denom = np.where(rng.random(6) < 0.3, 0, num + rng.integers(0, 3, 6)).astype(np.float32)
    w = rng.integers(0, 4, 6).astype(np.float32)
    close(torch_utils.class_reduce(torch.from_numpy(num), torch.from_numpy(denom), torch.from_numpy(w),
                                   class_reduction),
          jax_utils.class_reduce(jnp.asarray(num), jnp.asarray(denom), jnp.asarray(w), class_reduction))


def test_reductions_refuse_unknown_names_as_jax():
    x = torch.ones(3)
    with pytest.raises(ValueError, match="Reduction parameter unknown"):
        torch_utils.reduce(x, "bogus")
    with pytest.raises(ValueError, match="Reduction parameter bogus unknown"):
        torch_utils.class_reduce(x, x, x, "bogus")


@pytest.mark.parametrize("fn,level", [("rank_zero_info", logging.INFO), ("rank_zero_debug", logging.DEBUG)])
def test_rank_zero_info_and_debug_log_on_rank_zero(fn, level, caplog):
    caplog.set_level(logging.DEBUG, logger="metrics_tpu_torch")
    getattr(torch_utils, fn)(f"port {fn}")
    assert [(r.levelno, r.getMessage()) for r in caplog.records if r.name == "metrics_tpu_torch"] == [
        (level, f"port {fn}")]


def test_check_forward_full_state_property_prints_its_verdict(capsys):
    torch_utils.check_forward_full_state_property(
        T.MeanSquaredError, init_args=CPU,
        input_args={"preds": torch.arange(4.0), "target": torch.ones(4)},
        num_update_to_compare=(2, 4), reps=1,
    )
    out = capsys.readouterr().out
    assert "Output equal: True" in out


def test_allclose_recursive_matches_jax():
    from metrics_tpu.utils.checks import _allclose_recursive as jax_allclose
    from metrics_tpu_torch.utils.checks import _allclose_recursive

    a = {"x": [torch.ones(2), (torch.zeros(1),)]}
    b = {"x": [torch.ones(2) + 1e-9, (torch.zeros(1) + 1,)]}
    ja = {"x": [jnp.ones(2), (jnp.zeros(1),)]}
    jb = {"x": [jnp.ones(2) + 1e-9, (jnp.zeros(1) + 1,)]}
    assert _allclose_recursive(a, a) == jax_allclose(ja, ja) is True
    assert _allclose_recursive(a, b) == jax_allclose(ja, jb) is False


@pytest.mark.parametrize("name", ["bootstrapping", "classwise", "minmax", "multioutput", "tracker"])
def test_docstring_examples_run(name):
    result = doctest.testmod(importlib.import_module(f"metrics_tpu_torch.wrappers.{name}"), verbose=False)
    assert result.failed == 0 and result.attempted > 0
