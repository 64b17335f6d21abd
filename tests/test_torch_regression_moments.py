"""The port's moment regression metrics (``regression/moments.py``, functional
and module) against the JAX package's, on the CPU.

Pearson, concordance, explained variance and R² (``adjusted`` and the three
``multioutput`` modes) over the same numpy batches in both packages: N = 211
rows, one column or four. Tolerances: states and values within rtol 1e-5,
atol 5e-5: float32 sums of a few hundred terms of order 1 that the two
frameworks add in other orders (the JAX package's eager CPU route sums 1-D
explained variance and R² as BLAS dots), so a sum that cancels to near 0
keeps an absolute rounding of ~1e-5; the row counts are float32 and equal.
Every state is float32 whatever the input dtype (float64, float16, int32,
int64; ROADMAP C.8), with the JAX package's shapes. Errors are of the JAX
package's types.
"""

import doctest
import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional.regression as jax_fn
import metrics_tpu.regression as jax_reg
import metrics_tpu_torch.functional.regression as torch_fn
import metrics_tpu_torch.regression as torch_reg
from metrics_tpu.regression.moments import _final_aggregation as jax_final_aggregation
from metrics_tpu_torch.regression.moments import _final_aggregation

CPU = {"device": "cpu"}
N = 211
RTOL, ATOL = 1e-5, 5e-5


def close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    assert isinstance(got, torch.Tensor), type(got)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype), (got.dtype, want.dtype)
    assert tuple(got.shape) == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


def _batch(rng, cols=1, n=N):
    shape = (n,) if cols == 1 else (n, cols)
    target = rng.normal(1.0, 2.0, size=shape).astype(np.float32)
    preds = (0.7 * target + rng.normal(0.3, 1.0, size=shape)).astype(np.float32)
    return preds, target


def _pair(p, t):
    return (jnp.asarray(p), jnp.asarray(t)), (torch.from_numpy(np.ascontiguousarray(p)),
                                              torch.from_numpy(np.ascontiguousarray(t)))


# name -> (class, functional, constructor arguments, functional arguments, columns)
CASES = {
    "pearson": ("PearsonCorrCoef", "pearson_corrcoef", {}, {}, 1),
    "pearson4": ("PearsonCorrCoef", "pearson_corrcoef", {"num_outputs": 4}, {}, 4),
    "concordance": ("ConcordanceCorrCoef", "concordance_corrcoef", {}, {}, 1),
    "concordance4": ("ConcordanceCorrCoef", "concordance_corrcoef", {"num_outputs": 4}, {}, 4),
    "explained_variance": ("ExplainedVariance", "explained_variance", {}, {}, 1),
    "explained_variance_raw": ("ExplainedVariance", "explained_variance", {"multioutput": "raw_values"},
                               {"multioutput": "raw_values"}, 4),
    "explained_variance_uniform": ("ExplainedVariance", "explained_variance", {}, {}, 4),
    "explained_variance_weighted": ("ExplainedVariance", "explained_variance", {"multioutput": "variance_weighted"},
                                    {"multioutput": "variance_weighted"}, 4),
    "r2": ("R2Score", "r2_score", {}, {}, 1),
    "r2_adjusted": ("R2Score", "r2_score", {"adjusted": 5}, {"adjusted": 5}, 1),
    "r2_raw": ("R2Score", "r2_score", {"num_outputs": 4, "multioutput": "raw_values"},
               {"multioutput": "raw_values"}, 4),
    "r2_uniform": ("R2Score", "r2_score", {"num_outputs": 4}, {}, 4),
    "r2_weighted": ("R2Score", "r2_score", {"num_outputs": 4, "multioutput": "variance_weighted", "adjusted": 3},
                    {"multioutput": "variance_weighted", "adjusted": 3}, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moments_match_jax(case):
    """Three batches: functional on each, ``update`` / ``forward`` / ``update``
    on the module, every state after each, ``update_state`` / ``compute_from``."""
    cls, fn, kw, fkw, cols = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    batches = [_batch(rng, cols) for _ in range(3)]
    jm, tm = getattr(jax_reg, cls)(**kw), getattr(torch_reg, cls)(**kw, **CPU)
    jstate, tstate = jm.init_state(), tm.init_state()
    for i, (p, t) in enumerate(batches):
        (jp, jt), (tp, tt) = _pair(p, t)
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


@pytest.mark.parametrize("dtype", [np.float64, np.float16, np.int32, np.int64])
@pytest.mark.parametrize("case", ["pearson", "concordance", "explained_variance", "r2", "r2_raw"])
def test_states_stay_float32_for_every_input_dtype(case, dtype):
    """Float64, float16 and integer inputs: every state float32 with the JAX
    package's value (ROADMAP C.8), the functional's value and dtype too."""
    cls, fn, kw, fkw, cols = CASES[case]
    rng = np.random.default_rng(7)
    p, t = _batch(rng, cols)
    p, t = ((x.astype(dtype) if np.issubdtype(dtype, np.floating) else np.rint(3 * x).astype(dtype)) for x in (p, t))
    (jp, jt), (tp, tt) = _pair(p, t)
    rtol = 1e-3 if dtype == np.float16 else RTOL
    close(getattr(torch_fn, fn)(tp, tt, **fkw), getattr(jax_fn, fn)(jp, jt, **fkw), rtol=rtol)
    jm, tm = getattr(jax_reg, cls)(**kw), getattr(torch_reg, cls)(**kw, **CPU)
    jm.update(jp, jt)
    tm.update(tp, tt)
    tstate = tm.update_state(tm.init_state(), tp, tt)
    for key in jm._defaults:
        assert getattr(tm, key).dtype == tstate[key].dtype == torch.float32, key
        close(getattr(tm, key), getattr(jm, key), rtol=rtol)
    close(tm.compute(), jm.compute(), rtol=rtol)


@pytest.mark.parametrize("cols", [1, 3])
def test_pearson_merged_from_stacked_halves_equals_one_metric(cols):
    """Two replicas' Welford states stacked (a sync's ``dist_reduce_fx=None``
    gather) merge by ``_final_aggregation`` to one metric fed both halves, and
    to the JAX package's merge of the same stacks."""
    rng = np.random.default_rng(3 + cols)
    p, t = _batch(rng, cols, n=400)
    kw = {"num_outputs": cols} if cols > 1 else {}
    whole, halves = torch_reg.PearsonCorrCoef(**kw, **CPU), [torch_reg.PearsonCorrCoef(**kw, **CPU) for _ in range(2)]
    whole.update(torch.from_numpy(p), torch.from_numpy(t))
    jhalves = [jax_reg.PearsonCorrCoef(**kw) for _ in range(2)]
    for m, jm, part in zip(halves, jhalves, (slice(0, 150), slice(150, 400))):
        m.update(torch.from_numpy(p[part]), torch.from_numpy(t[part]))
        jm.update(jnp.asarray(p[part]), jnp.asarray(t[part]))
    names = ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")
    stacked = [torch.stack([getattr(m, k) for m in halves]) for k in names]
    merged = _final_aggregation(*stacked)
    jmerged = jax_final_aggregation(*[jnp.stack([getattr(m, k) for m in jhalves]) for k in names])
    for name, got, want, ref in zip(names, merged, jmerged, (getattr(whole, k) for k in names)):
        close(got, want)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4, err_msg=name)
    # the module's compute reads a stacked state the same way (a synced metric)
    synced = torch_reg.PearsonCorrCoef(**kw, **CPU)
    for name, value in zip(names, stacked):
        setattr(synced, name, value)
    synced._update_called = True
    close(synced.compute(), whole.compute(), rtol=1e-4, atol=1e-5)


def test_constant_inputs_give_nan_like_jax():
    p = np.full(8, 2.0, np.float32)
    t = np.arange(8, dtype=np.float32)
    (jp, jt), (tp, tt) = _pair(p, t)
    for fn in ("pearson_corrcoef", "concordance_corrcoef"):
        got, want = getattr(torch_fn, fn)(tp, tt), getattr(jax_fn, fn)(jp, jt)
        assert torch.isnan(got) and np.isnan(np.asarray(want))
    close(torch_fn.r2_score(tt, tp), jax_fn.r2_score(jt, jp))  # constant target: -inf
    close(torch_fn.explained_variance(tt, tp), jax_fn.explained_variance(jt, jp))  # zero denominator: 0
    close(torch_fn.explained_variance(tp, tp), jax_fn.explained_variance(jp, jp))  # zero numerator: 1


@pytest.mark.parametrize("adjusted,n", [(9, 10), (12, 10)])
def test_degenerate_adjusted_r2_warns_and_falls_back_like_jax(adjusted, n):
    rng = np.random.default_rng(adjusted)
    (jp, jt), (tp, tt) = _pair(*_batch(rng, 1, n=n))
    with pytest.warns(UserWarning):
        want = jax_fn.r2_score(jp, jt, adjusted=adjusted)
    with pytest.warns(UserWarning):
        got = torch_fn.r2_score(tp, tt, adjusted=adjusted)
    close(got, want)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        close(got, torch_fn.r2_score(tp, tt))


def test_errors_match_jax_types():
    bad = (np.zeros(4, np.float32), np.zeros(5, np.float32))
    for fn in ("pearson_corrcoef", "concordance_corrcoef", "explained_variance", "r2_score"):
        with pytest.raises(RuntimeError):
            getattr(jax_fn, fn)(*(jnp.asarray(b) for b in bad))
        with pytest.raises(RuntimeError):
            getattr(torch_fn, fn)(*(torch.from_numpy(b) for b in bad))
    one = (np.ones(1, np.float32), np.ones(1, np.float32))
    for pkg, arr in ((jax_fn, jnp.asarray), (torch_fn, torch.from_numpy)):
        with pytest.raises(ValueError, match="at least two samples"):
            pkg.r2_score(*(arr(b) for b in one))
        with pytest.raises(ValueError):
            pkg.r2_score(*(arr(b) for b in _batch(np.random.default_rng(0))), multioutput="bad")
        with pytest.raises(ValueError):
            pkg.explained_variance(*(arr(b) for b in _batch(np.random.default_rng(0))), multioutput="bad")
        with pytest.raises(ValueError):
            pkg.r2_score(*(arr(b) for b in _batch(np.random.default_rng(0))), adjusted=-1)
    for cls, kw in (("PearsonCorrCoef", {"num_outputs": 0}), ("ConcordanceCorrCoef", {"num_outputs": 1.5}),
                    ("R2Score", {"adjusted": -1}), ("R2Score", {"multioutput": "bad"}),
                    ("ExplainedVariance", {"multioutput": "bad"})):
        with pytest.raises(ValueError):
            getattr(jax_reg, cls)(**kw)
        with pytest.raises(ValueError):
            getattr(torch_reg, cls)(**kw, **CPU)
    jm, tm = jax_reg.R2Score(), torch_reg.R2Score(**CPU)
    jm.update(*(jnp.asarray(b) for b in one))
    tm.update(*(torch.from_numpy(b) for b in one))
    with pytest.raises(ValueError, match="at least two samples"):
        jm.compute()
    with pytest.raises(ValueError, match="at least two samples"):
        tm.compute()


@pytest.mark.parametrize("module", ["metrics_tpu_torch.regression.moments",
                                    "metrics_tpu_torch.functional.regression.moments"])
def test_docstring_examples_run(module):
    result = doctest.testmod(importlib.import_module(module), verbose=False)
    assert result.attempted > 0 and result.failed == 0
