"""The port's aggregators (``metrics_tpu_torch/aggregation.py``) against the JAX
package's, on the CPU.

Every aggregator runs under every ``nan_strategy`` ("error", "warn", "ignore"
and a float imputation), ``MeanMetric`` also with a scalar and a per-value
weight, over the same numpy batches: some with NaN, one a Python float. Both
packages must raise (``RuntimeError`` under "error") and warn
(``UserWarning`` under "warn") on the same batches. Max, Min and Cat are
exact; Sum and Mean within rtol=1e-6 (float32 sums of at most 40 values in
[0, 1) that the two frameworks add in other orders).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.aggregation as jax_agg
import metrics_tpu_torch.aggregation as torch_agg

STRATEGIES = ["error", "warn", "ignore", 2.5]
EXACT = {"MaxMetric", "MinMetric", "CatMetric"}
CASES = [(name, None) for name in ("SumMetric", "MaxMetric", "MinMetric", "CatMetric")] + [
    ("MeanMetric", w) for w in (None, "scalar", "array")
]


def _batches(seed):
    """Float32 batches in [0, 1), NaNs in the second and fourth, a Python float last."""
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate((7, 40, 1, 13)):
        x = rng.random(n).astype(np.float32)
        if i in (1, 3):
            x[rng.random(n) < 0.3] = np.nan
            x[0] = np.nan
        out.append(x)
    out.append(0.625)
    return out


def _weight(kind, x, rng):
    if kind is None:
        return None
    if kind == "scalar":
        return 2.0
    return rng.random(np.shape(x)).astype(np.float32)


def _update(metric, x, w, to):
    if w is None:
        metric.update(to(x))
    else:
        metric.update(to(x), to(w))


def _to_jax(v):
    return jnp.asarray(v) if isinstance(v, np.ndarray) else v


def _to_torch(v):
    return torch.from_numpy(v) if isinstance(v, np.ndarray) else v


def _assert_close(name, got, want):
    want = np.asarray(want)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    if name in EXACT:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("strategy", STRATEGIES, ids=str)
@pytest.mark.parametrize("name,weight", CASES, ids=[f"{n}-{w}" for n, w in CASES])
def test_aggregator_matches_jax(name, weight, strategy):
    jm = getattr(jax_agg, name)(nan_strategy=strategy)
    tm = getattr(torch_agg, name)(nan_strategy=strategy, device="cpu")
    rng = np.random.default_rng(5)
    for x in _batches(seed=3):
        w = _weight(weight, x, rng)
        has_nan = bool(np.isnan(x).any())
        if strategy == "error" and has_nan:
            with pytest.raises(RuntimeError, match="nan"):
                _update(jm, x, w, _to_jax)
            with pytest.raises(RuntimeError, match="nan"):
                _update(tm, x, w, _to_torch)
        elif strategy == "warn" and has_nan:
            with pytest.warns(UserWarning, match="nan"):
                _update(jm, x, w, _to_jax)
            with pytest.warns(UserWarning, match="nan"):
                _update(tm, x, w, _to_torch)
        else:
            with warnings.catch_warnings():
                warnings.simplefilter("error")  # neither side warns on a batch without NaN
                _update(jm, x, w, _to_jax)
                _update(tm, x, w, _to_torch)
        assert tm.update_count == jm.update_count
        for key in jm._defaults:
            got, want = getattr(tm, key), getattr(jm, key)
            if isinstance(want, list):
                assert len(got) == len(want)
                for g, v in zip(got, want):
                    np.testing.assert_array_equal(g.numpy(), np.asarray(v))
            else:
                _assert_close(name, got, want)
    _assert_close(name, tm.compute(), jm.compute())


@pytest.mark.parametrize("strategy", ["warn", "ignore", 2.5], ids=str)
@pytest.mark.parametrize("name", ["SumMetric", "MeanMetric", "MaxMetric", "MinMetric", "CatMetric"])
def test_forward_and_functional_api_match_jax(name, strategy):
    """``forward`` (Max and Min take the full-state path, the others the
    reduced one) and ``init_state`` / ``update_state`` / ``compute_from`` /
    ``merge_states``."""
    jm = getattr(jax_agg, name)(nan_strategy=strategy)
    tm = getattr(torch_agg, name)(nan_strategy=strategy, device="cpu")
    batches = [b for b in _batches(seed=4) if isinstance(b, np.ndarray) and b.size > 1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "warn" warns on both sides; test_aggregator_matches_jax holds that
        for x in batches:
            _assert_close(name, tm(torch.from_numpy(x)), jm(jnp.asarray(x)))
        _assert_close(name, tm.compute(), jm.compute())
        ja, ta = jm.init_state(), tm.init_state()
        for x in batches:
            ja, ta = jm.update_state(ja, jnp.asarray(x)), tm.update_state(ta, torch.from_numpy(x))
        # a fresh initial state for the JAX side: its eager update_state appends into the list
        # state it is given (the port's does not)
        jb = jm.update_state(jm.init_state(), jnp.asarray(batches[0]))
        tb = tm.update_state(tm.init_state(), torch.from_numpy(batches[0]))
    _assert_close(name, tm.compute_from(ta), jm.compute_from(ja))
    _assert_close(name, tm.compute_from(tm.merge_states(ta, tb)), jm.compute_from(jm.merge_states(ja, jb)))


def test_cat_metric_without_values_computes_an_empty_list():
    assert torch_agg.CatMetric(device="cpu").compute() == [] == jax_agg.CatMetric().compute()


@pytest.mark.parametrize("bad", ["median", 1, None])
def test_bad_nan_strategy_raises_like_jax(bad):
    with pytest.raises(ValueError, match="nan_strategy"):
        jax_agg.SumMetric(nan_strategy=bad)
    with pytest.raises(ValueError, match="nan_strategy"):
        torch_agg.SumMetric(nan_strategy=bad, device="cpu")


def test_states_keep_the_jax_dtypes_and_the_device():
    for name in ("SumMetric", "MeanMetric", "MaxMetric", "MinMetric"):
        jm, tm = getattr(jax_agg, name)(), getattr(torch_agg, name)(device="cpu")
        for key, want in jm._defaults.items():
            got = tm._defaults[key]
            assert str(got.dtype).replace("torch.", "") == str(np.asarray(want).dtype)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert getattr(tm, key).device == torch.device("cpu")


def test_aggregator_without_device_raises_on_a_gpu_less_machine():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: device=None resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_agg.MeanMetric()


def test_docstring_examples():
    import doctest

    result = doctest.testmod(torch_agg, verbose=False)
    assert result.failed == 0 and result.attempted >= 5
