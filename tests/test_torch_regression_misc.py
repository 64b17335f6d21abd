"""The port's other regression metrics (``regression/misc.py``, functional and
module) against the JAX package's, on the CPU.

Cosine similarity, KL divergence (``log_prob`` and every reduction), Tweedie
deviance (powers below 0, 0, 1, between 1 and 2, 2 and above 2), Spearman's
and Kendall's rank correlations (variants a, b and c, ``t_test`` with the
three alternatives) over the same numpy inputs in both packages, with tied
values. Tolerances: values and float states within rtol 1e-5, atol 1e-5
(float32 sums in other orders); float16 inputs, which the JAX package sums in
float16 where it keeps them, within rtol 1e-2. Integer results are exact:
Spearman's ranks equal the JAX package's bit for bit, and Kendall's
concordant, discordant and tied pair counts equal an exact count, over
several tiles of the pair grid as over one. Every fixed-shape state is
float32 whatever the input dtype (ROADMAP C.8); list states keep the JAX
package's dtypes. Errors are of the JAX package's types.
"""

import doctest
import importlib
from itertools import combinations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional.regression as jax_fn
import metrics_tpu.regression as jax_reg
import metrics_tpu_torch.functional.regression as torch_fn
import metrics_tpu_torch.functional.regression.misc as torch_misc
import metrics_tpu_torch.regression as torch_reg
from metrics_tpu.functional.regression.misc import _rank_data_host

CPU = {"device": "cpu"}
RTOL, ATOL = 1e-5, 1e-5


def close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w, rtol, atol)
        return
    want = np.asarray(want)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype), (got.dtype, want.dtype)
    assert tuple(got.shape) == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


def both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _tied(rng, shape, levels=40):
    """Scores on a grid of ``levels`` values: many ties."""
    return (rng.integers(0, levels, shape) / levels).astype(np.float32)


def _module_run(cls, kw, batches, forward_at=1):
    """``update`` / ``forward`` / ``update`` on both packages' modules; every
    state after each, then compute."""
    jm, tm = getattr(jax_reg, cls)(**kw), getattr(torch_reg, cls)(**kw, **CPU)
    for i, arrays in enumerate(batches):
        j, t = both(*arrays)
        if i == forward_at:
            close(tm.forward(*t), jm.forward(*j))
        else:
            jm.update(*j)
            tm.update(*t)
        for key in jm._defaults:
            jv, tv = getattr(jm, key), getattr(tm, key)
            if isinstance(jv, list):
                assert len(tv) == len(jv)
                for a, b in zip(tv, jv):
                    close(a, b)
            else:
                close(tv, jv)
    close(tm.compute(), jm.compute())
    return jm, tm


# --------------------------------------------------------------------------- cosine similarity


@pytest.mark.parametrize("reduction", ["sum", "mean", "none", None])
def test_cosine_similarity_matches_jax(reduction):
    rng = np.random.default_rng(1)
    batches = [(rng.normal(size=(33, 16)).astype(np.float32), rng.normal(size=(33, 16)).astype(np.float32))
               for _ in range(3)]
    for p, t in batches:
        j, tt = both(p, t)
        close(torch_fn.cosine_similarity(*tt, reduction=reduction), jax_fn.cosine_similarity(*j, reduction=reduction))
    _module_run("CosineSimilarity", {"reduction": reduction}, batches)


# --------------------------------------------------------------------------- kl divergence


def _distributions(rng, n=29, c=7, log_prob=False):
    p = rng.random((n, c)).astype(np.float32) + 0.01
    q = rng.random((n, c)).astype(np.float32) + 0.01
    if log_prob:
        p, q = (np.log(x / x.sum(-1, keepdims=True)).astype(np.float32) for x in (p, q))
    return p, q


@pytest.mark.parametrize("log_prob", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none", None])
def test_kl_divergence_matches_jax(log_prob, reduction):
    rng = np.random.default_rng(2 + log_prob)
    batches = [_distributions(rng, log_prob=log_prob) for _ in range(3)]
    for p, q in batches:
        j, t = both(p, q)
        close(torch_fn.kl_divergence(*t, log_prob=log_prob, reduction=reduction),
              jax_fn.kl_divergence(*j, log_prob=log_prob, reduction=reduction))
    _module_run("KLDivergence", {"log_prob": log_prob, "reduction": reduction}, batches)


def test_kl_divergence_edge_values_match_jax():
    """A zero ``q`` under mass of ``p`` gives inf, a zero ``p`` contributes 0,
    and the functional's reduction outside the four names divides by the rows."""
    p = np.array([[0.5, 0.5, 0.0], [0.2, 0.3, 0.5]], np.float32)
    q = np.array([[0.0, 1.0, 0.0], [0.3, 0.3, 0.4]], np.float32)
    j, t = both(p, q)
    for reduction in ("none", "sum", "per_row"):
        close(torch_fn.kl_divergence(*t, reduction=reduction), jax_fn.kl_divergence(*j, reduction=reduction))


# --------------------------------------------------------------------------- tweedie


@pytest.mark.parametrize("power", [-0.5, 0.0, 1.0, 1.5, 2.0, 3.0])
def test_tweedie_deviance_matches_jax(power):
    rng = np.random.default_rng(int(10 * power) + 20)
    batches = [((rng.random(101) * 3 + 0.1).astype(np.float32), (rng.random(101) * 3 + 0.1).astype(np.float32))
               for _ in range(3)]
    if power == 0.0:  # any sign
        batches = [(p - 1.5, t - 1.5) for p, t in batches]
    if power == -0.5:  # target <= 0 takes the max(target, 0) branch
        batches = [(p, np.where(np.arange(101) % 7 == 0, -t, t).astype(np.float32)) for p, t in batches]
    for p, t in batches:
        j, tt = both(p, t)
        close(torch_fn.tweedie_deviance_score(*tt, power=power), jax_fn.tweedie_deviance_score(*j, power=power))
    _module_run("TweedieDevianceScore", {"power": power}, batches)


def test_tweedie_deviance_with_zero_targets_matches_jax():
    p = np.array([0.5, 1.0, 2.0], np.float32)
    t = np.array([0.0, 1.0, 0.0], np.float32)
    j, tt = both(p, t)
    close(torch_fn.tweedie_deviance_score(*tt, power=1), jax_fn.tweedie_deviance_score(*j, power=1))


# --------------------------------------------------------------------------- spearman


@pytest.mark.parametrize("n", [1, 2, 97, 5000])
def test_spearman_ranks_equal_the_jax_ranks_bit_for_bit(n):
    """Average ranks of tied values (and of NaN, each its own run), equal to
    the JAX package's CPU route's bit for bit."""
    rng = np.random.default_rng(n)
    x = _tied(rng, n, levels=max(2, n // 10))
    if n > 2:
        x[:: max(1, n // 5)] = np.nan
        x[1] = -0.0
        x[2] = 0.0
    got = torch_misc._rank_data(torch.from_numpy(x))
    want = _rank_data_host(x)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cols", [1, 3])
def test_spearman_matches_jax(cols):
    rng = np.random.default_rng(30 + cols)
    shape = (120,) if cols == 1 else (120, cols)
    batches = []
    for _ in range(3):
        t = _tied(rng, shape)
        batches.append(((0.5 * t + 0.5 * _tied(rng, shape)).astype(np.float32), t))
    whole = [np.concatenate(x) for x in zip(*batches)]
    j, t = both(*whole)
    close(torch_fn.spearman_corrcoef(*t), jax_fn.spearman_corrcoef(*j))
    _module_run("SpearmanCorrCoef", {"num_outputs": cols} if cols > 1 else {}, batches)


# --------------------------------------------------------------------------- kendall


def _exact_counts(x, y):
    c = d = tx = ty = 0
    for i, k in combinations(range(len(x)), 2):
        sx, sy = np.sign(x[i] - x[k]), np.sign(y[i] - y[k])
        c += int(sx * sy > 0)
        d += int(sx * sy < 0)
        tx += int(sx == 0)
        ty += int(sy == 0)
    return [c, d, tx, ty]


@pytest.mark.parametrize("tile", [1 << 24, 64, 7])
def test_kendall_counts_are_exact_over_any_tiling(tile, monkeypatch):
    """Concordant, discordant and tied pairs over one tile of the pair grid and
    over many (64 and 7 elements a tile: a row a tile), equal to an exact count."""
    monkeypatch.setattr(torch_misc, "_KENDALL_TILE_ELEMENTS", tile)
    rng = np.random.default_rng(4)
    x, y = _tied(rng, 60, levels=9), _tied(rng, 60, levels=7)
    got = torch_misc._kendall_counts(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.int64
    assert got.tolist() == _exact_counts(x, y)


@pytest.mark.parametrize("variant", ["a", "b", "c"])
@pytest.mark.parametrize("alternative", ["two-sided", "less", "greater"])
@pytest.mark.parametrize("t_test", [False, True])
def test_kendall_matches_jax(variant, alternative, t_test):
    rng = np.random.default_rng(ord(variant) + len(alternative))
    batches = []
    for _ in range(3):
        t = _tied(rng, 70, levels=12)
        batches.append(((0.6 * t + 0.4 * _tied(rng, 70, levels=12)).astype(np.float32), t))
    whole = [np.concatenate(x) for x in zip(*batches)]
    j, t = both(*whole)
    kw = {"variant": variant, "t_test": t_test, "alternative": alternative}
    close(torch_fn.kendall_rank_corrcoef(*t, **kw), jax_fn.kendall_rank_corrcoef(*j, **kw))
    _module_run("KendallRankCorrCoef", kw, batches)


def test_kendall_on_several_columns_matches_jax():
    rng = np.random.default_rng(5)
    p, t = _tied(rng, (80, 3), levels=10), _tied(rng, (80, 3), levels=10)
    j, tt = both(p, t)
    for variant in ("a", "b", "c"):
        close(torch_fn.kendall_rank_corrcoef(*tt, variant=variant, t_test=True),
              jax_fn.kendall_rank_corrcoef(*j, variant=variant, t_test=True))


# --------------------------------------------------------------------------- dtypes


FIXED_STATE = [("TweedieDevianceScore", {"power": 1.5}), ("KLDivergence", {}), ("KLDivergence", {"reduction": "sum"})]
LIST_STATE = [("CosineSimilarity", {}), ("KLDivergence", {"reduction": None}), ("SpearmanCorrCoef", {}),
              ("KendallRankCorrCoef", {})]


def _inputs(cls, dtype, rng):
    if cls in ("CosineSimilarity", "KLDivergence"):
        p, q = _distributions(rng)
    else:
        p, q = (rng.random(64) * 3 + 0.5).astype(np.float32), (rng.random(64) * 3 + 0.5).astype(np.float32)
    if np.issubdtype(dtype, np.floating):
        return p.astype(dtype), q.astype(dtype)
    return np.rint(4 * p).astype(dtype) + 1, np.rint(4 * q).astype(dtype) + 1


# Spearman refuses integer input (test_errors_match_jax_types)
DTYPE_CASES = [(cls, kw, dtype) for cls, kw in FIXED_STATE + LIST_STATE
               for dtype in (np.float64, np.float16, np.int32, np.int64)
               if cls != "SpearmanCorrCoef" or np.issubdtype(dtype, np.floating)]


@pytest.mark.parametrize("cls,kw,dtype", DTYPE_CASES,
                         ids=[f"{c}-{k}-{np.dtype(d).name}" for c, k, d in DTYPE_CASES])
def test_states_keep_the_jax_dtypes(cls, kw, dtype):
    """Fixed-shape states float32 for every input dtype (ROADMAP C.8); list
    states and values of the JAX package's dtype and value."""
    rng = np.random.default_rng(9)
    p, q = _inputs(cls, dtype, rng)
    j, t = both(p, q)
    jm, tm = getattr(jax_reg, cls)(**kw), getattr(torch_reg, cls)(**kw, **CPU)
    jm.update(*j)
    tm.update(*t)
    rtol = 1e-2 if dtype == np.float16 else RTOL
    for key in jm._defaults:
        jv, tv = getattr(jm, key), getattr(tm, key)
        if isinstance(jv, list):
            close(tv[0], jv[0], rtol=rtol)
        else:
            assert tv.dtype == torch.float32, key
            close(tv, jv, rtol=rtol)
    close(tm.compute(), jm.compute(), rtol=rtol)


# --------------------------------------------------------------------------- errors and docs


def test_errors_match_jax_types():
    bad = (np.zeros((4, 3), np.float32), np.zeros((5, 3), np.float32))
    for fn in ("cosine_similarity", "kl_divergence", "tweedie_deviance_score", "spearman_corrcoef",
               "kendall_rank_corrcoef"):
        with pytest.raises(RuntimeError):
            getattr(jax_fn, fn)(*(jnp.asarray(b) for b in bad))
        with pytest.raises(RuntimeError):
            getattr(torch_fn, fn)(*(torch.from_numpy(b) for b in bad))
    flat = (np.ones(4, np.float32), np.ones(4, np.float32))
    ints = (np.ones(4, np.int32), np.ones(4, np.int32))
    cases = [
        ("cosine_similarity", flat, {}, ValueError),
        ("kl_divergence", flat, {}, ValueError),
        ("tweedie_deviance_score", flat, {"power": 0.5}, ValueError),
        ("spearman_corrcoef", ints, {}, TypeError),
        ("kendall_rank_corrcoef", flat, {"variant": "d"}, ValueError),
        ("kendall_rank_corrcoef", flat, {"t_test": 1}, ValueError),
        ("kendall_rank_corrcoef", flat, {"t_test": True, "alternative": "sideways"}, ValueError),
    ]
    for fn, arrays, kw, err in cases:
        with pytest.raises(err):
            getattr(jax_fn, fn)(*(jnp.asarray(a) for a in arrays), **kw)
        with pytest.raises(err):
            getattr(torch_fn, fn)(*(torch.from_numpy(a) for a in arrays), **kw)
    for cls, kw, err in (("CosineSimilarity", {"reduction": "max"}, ValueError),
                         ("KLDivergence", {"reduction": "max"}, ValueError),
                         ("KLDivergence", {"log_prob": 1}, TypeError),
                         ("TweedieDevianceScore", {"power": 0.3}, ValueError),
                         ("SpearmanCorrCoef", {"num_outputs": 0}, ValueError),
                         ("KendallRankCorrCoef", {"variant": "z"}, ValueError),
                         ("KendallRankCorrCoef", {"t_test": "yes"}, ValueError)):
        with pytest.raises(err):
            getattr(jax_reg, cls)(**kw)
        with pytest.raises(err):
            getattr(torch_reg, cls)(**kw, **CPU)
    jm, tm = jax_reg.SpearmanCorrCoef(), torch_reg.SpearmanCorrCoef(**CPU)
    with pytest.raises(TypeError):
        jm.update(*(jnp.asarray(a) for a in ints))
    with pytest.raises(TypeError):
        tm.update(*(torch.from_numpy(a) for a in ints))


@pytest.mark.parametrize("module", ["metrics_tpu_torch.regression.misc",
                                    "metrics_tpu_torch.functional.regression.misc"])
def test_docstring_examples_run(module):
    result = doctest.testmod(importlib.import_module(module), verbose=False)
    assert result.attempted > 0 and result.failed == 0
