"""The port's nominal association metrics (Cramér's V, Pearson's contingency
coefficient, Tschuprow's T, Theil's U) against the JAX package's, on the CPU.

The same seeded numpy labels go through both packages: int32 and int64 labels,
float label vectors with NaNs under ``nan_strategy="replace"`` (0.0 and -1.0:
a negative category is dropped by the pair count) and ``"drop"``, float32,
float64 and float16 score matrices (argmax over dim 1), both bias
corrections. The contingency tables (the modules' ``confmat`` state) are int32
and bit-identical; the statistics are float32 within ``RTOL``/``ATOL``: chi2
and Theil's entropies are float32 sums that XLA and torch take in another
order. Labels above 2^24 round through float32 as in the JAX package, and
int64 labels count by their low 32 bits (2^31 wraps negative and drops,
2^32 + k is k). The bias correction's NaN comes with the JAX package's
warning, and Theil's U of a constant ``preds`` is 0.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jax_top
import metrics_tpu.functional as jax_fn
import metrics_tpu_torch as torch_top
import metrics_tpu_torch.functional as torch_fn
from metrics_tpu_torch.kernels import confmat

CPU = {"device": "cpu"}
RTOL = 1e-5  # float32 sums of the same table in another order
ATOL = 1e-6
C = 5
N = 96
D = 4  # columns of the *_matrix inputs
FUNCTIONALS = ("cramers_v", "pearsons_contingency_coefficient", "tschuprows_t", "theils_u")
MODULES = {"cramers_v": "CramersV", "pearsons_contingency_coefficient": "PearsonsContingencyCoefficient",
           "tschuprows_t": "TschuprowsT", "theils_u": "TheilsU"}
BIASED = ("cramers_v", "tschuprows_t")  # the two with a ``bias_correction`` argument


def close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype), (got.dtype, want.dtype)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol, equal_nan=True)


def both(*arrays):
    return tuple(jnp.asarray(a) for a in arrays), tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def labels(rng, kind, n=N, classes=C):
    """(preds, target): int labels of ``kind`` (a numpy dtype name), float
    label vectors with NaNs ("nan"), or float score matrices ("scores_<dtype>")."""
    target = rng.integers(0, classes, n)
    preds = np.where(rng.random(n) < 0.5, target, rng.integers(0, classes, n))
    if kind in ("int32", "int64"):
        return preds.astype(kind), target.astype(kind)
    if kind == "nan":
        p, t = preds.astype(np.float32), target.astype(np.float32)
        p[rng.random(n) < 0.1] = np.nan
        t[rng.random(n) < 0.1] = np.nan
        return p, t
    dtype = kind.split("_")[1]
    scores = rng.random((n, classes)) * 0.5
    scores[np.arange(n), preds] += 1.0  # the argmax is ``preds``, well apart in float16
    return scores.astype(dtype), target.astype(np.int64)


KINDS = ("int32", "int64", "nan", "scores_float32", "scores_float64", "scores_float16")
NAN_ARGS = ({"nan_strategy": "replace", "nan_replace_value": 0.0},
            {"nan_strategy": "replace", "nan_replace_value": -1.0},
            {"nan_strategy": "drop"})
CASES = [(fn, kind, nan, bias) for fn in FUNCTIONALS for kind in KINDS for nan in range(len(NAN_ARGS))
         for bias in ((True, False) if fn in BIASED else (None,))]


def seed_of(*parts):
    return sum(map(ord, repr(parts)))


def _kw(fn, nan, bias):
    kw = dict(NAN_ARGS[nan])
    if bias is not None:
        kw["bias_correction"] = bias
    return kw


@pytest.mark.parametrize("fn,kind,nan,bias", CASES, ids=[f"{f}-{k}-nan{n}-bias{b}" for f, k, n, b in CASES])
def test_functionals_match_jax(fn, kind, nan, bias):
    rng = np.random.default_rng(seed_of(fn, kind, nan, bias))
    jb, tb = both(*labels(rng, kind))
    kw = _kw(fn, nan, bias)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        close(getattr(torch_fn, fn)(*tb, **kw), getattr(jax_fn, fn)(*jb, **kw))


MATRIX_CASES = [(fn, kind, nan) for fn in FUNCTIONALS for kind in ("int64", "nan") for nan in range(len(NAN_ARGS))]


@pytest.mark.parametrize("fn,kind,nan", MATRIX_CASES, ids=[f"{f}_matrix-{k}-nan{n}" for f, k, n in MATRIX_CASES])
def test_matrix_forms_match_jax_and_count_one_table_a_pair(fn, kind, nan):
    """Each ``*_matrix`` over D columns: the JAX package's values, and one pair
    count a column pair (D(D-1)/2), an ordered pair for Theil's U (D(D-1))."""
    rng = np.random.default_rng(seed_of(fn, kind, nan))
    cols = [labels(rng, kind)[i % 2] for i in range(D)]
    matrix = np.stack(cols, axis=1)
    jm, tm = both(matrix)
    kw = _kw(fn, nan, True if fn in BIASED else None)
    calls = []
    real = confmat.pair_count
    with warnings.catch_warnings(), pytest.MonkeyPatch.context() as mp:
        warnings.simplefilter("ignore")
        mp.setattr(confmat, "pair_count", lambda *a, **k: calls.append(a[2:4]) or real(*a, **k))
        got = getattr(torch_fn, f"{fn}_matrix")(*tm, **kw)
        close(got, getattr(jax_fn, f"{fn}_matrix")(*jm, **kw))
    assert len(calls) == (D * (D - 1) if fn == "theils_u" else D * (D - 1) // 2)
    assert torch.equal(torch.diagonal(got), torch.ones(D))


def _module_run(cls_name, kw, batches):
    jm = getattr(jax_top, cls_name)(C, **kw)
    tm = getattr(torch_top, cls_name)(C, **kw, **CPU)
    jstate, tstate = jm.init_state(), tm.init_state()
    for i, batch in enumerate(batches):
        jb, tb = both(*batch)
        if i % 2:
            close(tm.forward(*tb), jm.forward(*jb))
        else:
            jm.update(*jb)
            tm.update(*tb)
        assert tm.confmat.dtype == torch.int32
        close(tm.confmat, jm.confmat)
        jstate, tstate = jm.update_state(jstate, *jb), tm.update_state(tstate, *tb)
    close(tstate["confmat"], jstate["confmat"])
    close(tm.compute(), jm.compute())
    close(tm.compute_from(tstate), jm.compute_from(jstate))
    return tm


MODULE_CASES = [(fn, kind, nan) for fn in FUNCTIONALS for kind in KINDS for nan in range(len(NAN_ARGS))]


@pytest.mark.parametrize("fn,kind,nan", MODULE_CASES, ids=[f"{MODULES[f]}-{k}-nan{n}" for f, k, n in MODULE_CASES])
def test_modules_match_jax(fn, kind, nan):
    rng = np.random.default_rng(seed_of(fn, kind, nan, "module"))
    batches = [labels(rng, kind) for _ in range(3)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tm = _module_run(MODULES[fn], dict(NAN_ARGS[nan]), batches)
    assert tm._host_compute


@pytest.mark.parametrize("fn", FUNCTIONALS)
def test_wide_int64_labels_count_by_their_low_32_bits(fn):
    """2^32 + k counts as k, 2^31 and 2^31 + k wrap negative and drop, labels
    above 2^24 lie past the table and drop: the modules' int32 tables and the
    functionals' values equal the JAX package's."""
    rng = np.random.default_rng(31)
    target = rng.integers(0, C, N).astype(np.int64)
    preds = target.copy()
    preds[::7] += 2**32
    preds[1::11] = 2**31 + rng.integers(0, C, len(preds[1::11]))
    preds[2::13] = 2**24 + 1 + rng.integers(0, C, len(preds[2::13]))
    target[3::17] += 2**32
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tm = _module_run(MODULES[fn], {}, [(preds, target)])
        dropped = np.zeros(N, bool)
        dropped[1::11] = dropped[2::13] = True
        assert int(tm.confmat.sum()) == N - dropped.sum()
        # the functionals on labels that wrap into a small table
        small = np.where(preds >= 2**31, preds % 2**32, target)
        jb, tb = both(small, target)
        close(getattr(torch_fn, fn)(*tb), getattr(jax_fn, fn)(*jb))


def test_labels_above_2_24_round_through_float32_as_in_jax():
    """int32 labels 2^24 + 1 and 2^24 round to 2^24 on the way through
    float32: both packages count them in one category."""
    base = 2**24
    preds = np.array([base, base + 1, base + 2, base + 3] * 6, np.int32) - base + 4
    preds[:4] = [base, base + 1, base + 2, base + 3]
    target = np.array([0, 1, 2, 3] * 6, np.int32)
    jb, tb = both(preds % 8, target)  # a small table: only the rounding is under test
    close(torch_fn.theils_u(*tb), jax_fn.theils_u(*jb))
    f32 = torch.tensor([base + 1, base + 3], dtype=torch.int32).to(torch.float32)
    assert f32.tolist() == [float(base), float(base + 4)]
    from metrics_tpu_torch.functional.nominal.stats import _format_nominal

    p, t = _format_nominal(torch.tensor([base + 1, base + 3]), torch.tensor([0, 1]), "replace", 0.0)
    assert p.dtype == torch.int32 and p.tolist() == [base, base + 4]


@pytest.mark.parametrize("fn", BIASED)
def test_the_bias_corrections_nan_comes_with_the_jax_warning(fn):
    """A corrected dimension of 1 (two samples, two categories a side): NaN
    and the JAX package's warning text, from the functional and the module."""
    preds, target = np.array([0, 1], np.int64), np.array([0, 1], np.int64)
    jb, tb = both(preds, target)
    with pytest.warns(UserWarning) as jw:
        want = getattr(jax_fn, fn)(*jb)
    with pytest.warns(UserWarning) as tw:
        got = getattr(torch_fn, fn)(*tb)
    close(got, want)
    assert torch.isnan(got)
    assert [str(w.message) for w in tw if "Unable" in str(w.message)] == \
        [str(w.message) for w in jw if "Unable" in str(w.message)]
    m = getattr(torch_top, MODULES[fn])(2, **CPU)
    m.update(*tb)
    with pytest.warns(UserWarning, match="Unable to compute"):
        assert torch.isnan(m.compute())
    # without the correction the value is defined
    close(getattr(torch_fn, fn)(*tb, bias_correction=False), getattr(jax_fn, fn)(*jb, bias_correction=False))


def test_theils_u_of_a_constant_preds_is_zero():
    preds, target = np.zeros(N, np.int64), np.random.default_rng(5).integers(0, C, N)
    jb, tb = both(preds, target)
    got = torch_fn.theils_u(*tb)
    close(got, jax_fn.theils_u(*jb))
    assert got.item() == 0.0
    m = torch_top.TheilsU(C, **CPU)
    m.update(*tb)
    assert m.compute().item() == 0.0


def test_a_negative_replace_value_drops_the_pairs_with_a_nan():
    """``nan_replace_value=-1`` sends NaNs to category -1, which the pair count
    drops: the table equals the one of the pairs without a NaN."""
    rng = np.random.default_rng(9)
    p, t = labels(rng, "nan")
    tm = torch_top.CramersV(C, nan_replace_value=-1.0, **CPU)
    tm.update(torch.from_numpy(p), torch.from_numpy(t))
    keep = ~(np.isnan(p) | np.isnan(t))
    want = confmat.pair_count_bincount(torch.from_numpy(p[keep]).long(), torch.from_numpy(t[keep]).long(), C, C)
    assert torch.equal(tm.confmat, want)
    drop = torch_top.CramersV(C, nan_strategy="drop", **CPU)
    drop.update(torch.from_numpy(p), torch.from_numpy(t))
    assert torch.equal(drop.confmat, want)


def _error(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


ERRORS = {
    "nan_strategy": lambda fn, top, xs: fn.cramers_v(xs[0], xs[1], nan_strategy="impute"),
    "replace_value": lambda fn, top, xs: fn.theils_u(xs[0], xs[1], nan_replace_value=None),
    "replace_value_str": lambda fn, top, xs: fn.tschuprows_t_matrix(xs[2], nan_replace_value="0"),
    "num_classes_zero": lambda fn, top, xs: top.CramersV(0, **({} if top is jax_top else CPU)),
    "num_classes_float": lambda fn, top, xs: top.TheilsU(2.0, **({} if top is jax_top else CPU)),
    "module_nan_strategy": lambda fn, top, xs: top.TschuprowsT(3, nan_strategy="zero", **({} if top is jax_top else CPU)),
}


@pytest.mark.parametrize("what", sorted(ERRORS))
def test_bad_arguments_raise_the_jax_errors(what):
    rng = np.random.default_rng(3)
    preds, target = labels(rng, "int64")
    jb, tb = both(preds, target, np.stack([preds, target], axis=1))
    assert _error(lambda: ERRORS[what](torch_fn, torch_top, tb)) == _error(lambda: ERRORS[what](jax_fn, jax_top, jb))


def test_a_nan_replace_value_of_nan_lands_in_category_0_as_in_jax():
    """``nan_replace_value=nan`` keeps the NaNs, and XLA converts a NaN to int32
    0 (a plain torch cast gives -2^31, a dropped pair): both packages count
    those pairs in category 0, functional and module."""
    rng = np.random.default_rng(41)
    p, t = labels(rng, "nan")
    jb, tb = both(p, t)
    kw = {"nan_replace_value": float("nan")}
    jm, tm = jax_top.TheilsU(C, **kw), torch_top.TheilsU(C, **kw, **CPU)
    jm.update(*jb)
    tm.update(*tb)
    close(tm.confmat, jm.confmat)
    assert int(tm.confmat.sum()) == N
    close(torch_fn.cramers_v(*tb, **kw), jax_fn.cramers_v(*jb, **kw))
