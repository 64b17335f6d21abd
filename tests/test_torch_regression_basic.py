"""The port's error-sum regression metrics (``regression/basic.py``, functional
and module) against the JAX package's, on the CPU.

MAE, MSE (and RMSE, and ``num_outputs`` 3), MAPE, SMAPE, WMAPE, MSLE and
LogCosh run over the same numpy batches (N = 257 float32 values, or 257 x 3)
in both packages. The error sums are float32 sums that the two frameworks add
in other orders (the JAX package's MSE takes a host BLAS dot on the CPU), so
states and values agree within rtol=1e-6; the counts (``total``) are float32
and equal. Shapes and dtypes of every state equal the JAX package's
(``total`` is float32, MSE's sum has shape ``(num_outputs,)`` when
``num_outputs > 1``). Errors are of the JAX package's types.
"""

import doctest

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional.regression as jax_fn
import metrics_tpu.regression as jax_reg
import metrics_tpu_torch.functional.regression as torch_fn
import metrics_tpu_torch.regression as torch_reg
from metrics_tpu_torch.engine import StreamingEngine

CPU = {"device": "cpu"}
N = 257
# class -> (functional, constructor arguments, inputs: "signed", "positive" (logs and percentages), "outputs")
METRICS = {
    "MeanAbsoluteError": ("mean_absolute_error", {}, "signed"),
    "MeanSquaredError": ("mean_squared_error", {}, "signed"),
    "RootMeanSquaredError": ("mean_squared_error", {"squared": False}, "signed"),
    "MeanSquaredError3": ("mean_squared_error", {"num_outputs": 3}, "outputs"),
    "MeanAbsolutePercentageError": ("mean_absolute_percentage_error", {}, "signed"),
    "SymmetricMeanAbsolutePercentageError": ("symmetric_mean_absolute_percentage_error", {}, "signed"),
    "WeightedMeanAbsolutePercentageError": ("weighted_mean_absolute_percentage_error", {}, "signed"),
    "MeanSquaredLogError": ("mean_squared_log_error", {}, "positive"),
    "LogCoshError": ("log_cosh_error", {}, "signed"),
    "LogCoshError3": ("log_cosh_error", {"num_outputs": 3}, "outputs"),
}


def _class(name):
    return {"RootMeanSquaredError": "MeanSquaredError", "MeanSquaredError3": "MeanSquaredError",
            "LogCoshError3": "LogCoshError"}.get(name, name)


def _batch(rng, inputs):
    shape = (N, 3) if inputs == "outputs" else (N,)
    preds = rng.normal(size=shape).astype(np.float32)
    target = (0.8 * preds + 0.2 * rng.normal(size=shape)).astype(np.float32)
    if inputs == "positive":
        preds, target = np.abs(preds), np.abs(target)
    return preds, target


def close(got, want):
    want = np.asarray(want)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype) and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_error_sums_match_jax(name):
    fn, kw, inputs = METRICS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    batches = [_batch(rng, inputs) for _ in range(3)]
    jm, tm = getattr(jax_reg, _class(name))(**kw), getattr(torch_reg, _class(name))(**kw, **CPU)
    jstate, tstate = jm.init_state(), tm.init_state()
    for i, (p, t) in enumerate(batches):
        jp, jt, tp, tt = jnp.asarray(p), jnp.asarray(t), torch.from_numpy(p), torch.from_numpy(t)
        if "num_outputs" not in kw:
            fkw = {k: v for k, v in kw.items() if k == "squared"}
            close(getattr(torch_fn, fn)(tp, tt, **fkw), getattr(jax_fn, fn)(jp, jt, **fkw))
        if i == 1:
            close(tm.forward(tp, tt), jm.forward(jp, jt))
        else:
            jm.update(jp, jt)
            tm.update(tp, tt)
        for key in jm._defaults:
            close(getattr(tm, key), getattr(jm, key))
        jstate, tstate = jm.update_state(jstate, jp, jt), tm.update_state(tstate, tp, tt)
    close(tm.compute(), jm.compute())
    close(tm.compute_from(tstate), jm.compute_from(jstate))


@pytest.mark.parametrize("dtype", [np.int32, np.float16])
def test_mean_squared_and_absolute_error_on_other_dtypes(dtype):
    """Integer inputs and half-precision inputs (accumulated in float32) give
    the JAX package's value and dtype."""
    rng = np.random.default_rng(1)
    p, t = (rng.normal(0, 4, N).astype(dtype) for _ in range(2))
    for fn in ("mean_squared_error", "mean_absolute_error"):
        close(getattr(torch_fn, fn)(torch.from_numpy(p), torch.from_numpy(t)),
              getattr(jax_fn, fn)(jnp.asarray(p), jnp.asarray(t)))
    jm, tm = jax_reg.MeanSquaredError(), torch_reg.MeanSquaredError(**CPU)
    jm.update(jnp.asarray(p), jnp.asarray(t))
    tm.update(torch.from_numpy(p), torch.from_numpy(t))
    close(tm.sum_squared_error, jm.sum_squared_error)
    close(tm.compute(), jm.compute())


# the seven classes with their functionals (C.8: every state float32 whatever the input dtype)
SEVEN = [(cls, fn) for cls, (fn, kw, inputs) in METRICS.items() if not kw]


@pytest.mark.parametrize("dtype", [np.float64, np.float16, np.int32, np.int64])
@pytest.mark.parametrize("name,fn", SEVEN, ids=[c for c, _ in SEVEN])
def test_error_sum_states_and_outputs_keep_the_jax_dtypes(name, fn, dtype):
    """Float64, float16 and integer inputs: every state of the seven classes
    stays float32 and each functional returns the JAX package's dtype (float32
    for float64 input, as with x64 off), with its value (ROADMAP C.8)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    p = rng.random(N) * 6 + 0.25
    t = np.abs(0.8 * p + rng.normal(size=N))
    p, t = (x.astype(dtype) if np.issubdtype(dtype, np.floating) else np.rint(2 * x).astype(dtype) for x in (p, t))
    jp, jt, tp, tt = jnp.asarray(p), jnp.asarray(t), torch.from_numpy(p), torch.from_numpy(t)
    close(getattr(torch_fn, fn)(tp, tt), getattr(jax_fn, fn)(jp, jt))
    jm, tm = getattr(jax_reg, name)(), getattr(torch_reg, name)(**CPU)
    jm.update(jp, jt)
    tm.update(tp, tt)
    tstate = tm.update_state(tm.init_state(), tp, tt)
    for key in jm._defaults:
        assert getattr(tm, key).dtype == tstate[key].dtype == torch.float32, key
        close(getattr(tm, key), getattr(jm, key))
        close(tstate[key], getattr(jm, key))
    close(tm.compute(), jm.compute())
    close(tm.compute_from(tstate), jm.compute())


def test_a_metric_that_saw_float64_restores_into_both_packages(tmp_path):
    """``save`` after float64 input, then ``restore`` into a fresh metric of
    each package (a float64 state raised ``CkptSchemaError`` before C.8)."""
    rng = np.random.default_rng(8)
    p, t = rng.normal(size=N), rng.normal(size=N)
    tm = torch_reg.MeanSquaredError(**CPU)
    tm.update(torch.from_numpy(p), torch.from_numpy(t))
    path = str(tmp_path / "mse.mtckpt")
    tm.save(path)
    back, jback = torch_reg.MeanSquaredError(**CPU), jax_reg.MeanSquaredError()
    back.restore(path)
    jback.restore(path)
    ref = jax_reg.MeanSquaredError()
    ref.update(jnp.asarray(p), jnp.asarray(t))
    for key in ref._defaults:
        close(getattr(back, key), getattr(ref, key))
        close(getattr(back, key), getattr(jback, key))
    close(back.compute(), jback.compute())


def test_percentage_errors_near_zero_targets_match_jax():
    """Targets at and next to 0: the epsilon clamp of the JAX package."""
    p = np.array([0.5, -1.0, 2.0, 1e-7, 0.0, 3.0], np.float32)
    t = np.array([0.0, 0.0, 1e-8, -1e-7, 0.0, 3.0], np.float32)
    for fn in ("mean_absolute_percentage_error", "symmetric_mean_absolute_percentage_error",
               "weighted_mean_absolute_percentage_error"):
        close(getattr(torch_fn, fn)(torch.from_numpy(p), torch.from_numpy(t)),
              getattr(jax_fn, fn)(jnp.asarray(p), jnp.asarray(t)))
    close(torch_fn.weighted_mean_absolute_percentage_error(torch.zeros(3), torch.zeros(3)),
          jax_fn.weighted_mean_absolute_percentage_error(jnp.zeros(3), jnp.zeros(3)))


def test_log_cosh_of_large_errors_stays_finite_like_jax():
    p = np.array([80.0, -80.0, 1e4, 0.0], np.float32)
    t = np.zeros(4, np.float32)
    got = torch_fn.log_cosh_error(torch.from_numpy(p), torch.from_numpy(t))
    assert torch.isfinite(got)
    close(got, jax_fn.log_cosh_error(jnp.asarray(p), jnp.asarray(t)))


def test_errors_match_jax_types():
    bad = (np.zeros(4, np.float32), np.zeros(5, np.float32))
    for fn in ("mean_absolute_error", "mean_squared_error", "mean_absolute_percentage_error",
               "symmetric_mean_absolute_percentage_error", "weighted_mean_absolute_percentage_error",
               "mean_squared_log_error", "log_cosh_error"):
        with pytest.raises(RuntimeError):
            getattr(jax_fn, fn)(*(jnp.asarray(b) for b in bad))
        with pytest.raises(RuntimeError):
            getattr(torch_fn, fn)(*(torch.from_numpy(b) for b in bad))
    for cls, kw in (("MeanSquaredError", {"squared": 1}), ("MeanSquaredError", {"num_outputs": 0}),
                    ("LogCoshError", {"num_outputs": -1})):
        with pytest.raises(ValueError):
            getattr(jax_reg, cls)(**kw)
        with pytest.raises(ValueError):
            getattr(torch_reg, cls)(**kw, **CPU)


def test_mean_squared_error_serves_on_the_engine():
    """``MeanSquaredError`` through the port's engine (the loop kernel on the CPU)
    equals a fold of the same requests, as the JAX plane tests serve it."""
    rng = np.random.default_rng(2)
    reqs = [(f"t{i % 3}", _batch(rng, "signed")[0][: 1 + i % 4], _batch(rng, "signed")[1][: 1 + i % 4])
            for i in range(12)]
    engine = StreamingEngine(torch_reg.MeanSquaredError(**CPU), buckets=(8,))
    try:
        for key, p, t in reqs:
            engine.submit(key, p, t)
        got = engine.compute_all()
        assert engine.fused and engine.telemetry_snapshot()["failed"] == 0
    finally:
        engine.close()
    for key in got:
        ref = jax_reg.MeanSquaredError()
        for k, p, t in reqs:
            if k == key:
                ref.update(jnp.asarray(p), jnp.asarray(t))
        close(got[key], ref.compute())


@pytest.mark.parametrize("module", ["regression", "functional"])
def test_docstring_examples_run(module):
    import importlib

    name = "metrics_tpu_torch.regression.basic" if module == "regression" else "metrics_tpu_torch.functional.regression.basic"
    result = doctest.testmod(importlib.import_module(name), verbose=False)
    assert result.attempted > 0 and result.failed == 0
