"""The port's retrieval metrics (``functional/retrieval``, ``retrieval/``)
against the JAX package's, on the CPU.

The nine per-query functionals and the ten module classes over the same numpy
inputs in both packages: float32 scores with deliberate ties (and -0.0 beside
0.0), binary targets as int32, int64 and bool, graded targets for nDCG,
queries with no positive (and, for fall-out, no negative) target, every
``empty_target_action``, ``ignore_index``, ``k`` / ``adaptive_k`` /
``max_k``. Ties must rank in input order (stable sorts), so every value on
tied scores is compared. Tolerances: values within rtol 1e-5, atol 1e-6
(per-query sums in float32); the module states (int32 ids, float32 scores,
the targets' dtypes) and the curve's int32 ``top_k`` are equal exactly, as
are the grouping's ranks and query ids. Errors are of the JAX package's types.
"""

import doctest
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional as jax_fn
import metrics_tpu.retrieval as jax_ret
import metrics_tpu_torch.functional as torch_fn
import metrics_tpu_torch.retrieval as torch_ret

CPU = {"device": "cpu"}
RTOL, ATOL = 1e-5, 1e-6


def close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w, rtol, atol)
        return
    want = np.asarray(want)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype), (got.dtype, want.dtype)
    assert tuple(got.shape) == want.shape, (got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def both(*arrays):
    return ([None if a is None else jnp.asarray(a) for a in arrays],
            [None if a is None else torch.from_numpy(np.array(a)) for a in arrays])


def _query(rng, n, pos_rate=0.3, levels=6, target_dtype=np.int32, graded=False):
    """One query: scores on ``levels`` values (ties), binary or graded targets."""
    preds = (rng.integers(0, levels, n) / levels).astype(np.float32)
    if graded:
        target = rng.integers(0, 4, n).astype(target_dtype)
    else:
        target = (rng.random(n) < pos_rate).astype(target_dtype)
    return preds, target


# --------------------------------------------------------------------------- functionals

FUNCTIONALS = [
    ("retrieval_average_precision", {}),
    ("retrieval_reciprocal_rank", {}),
    ("retrieval_r_precision", {}),
    ("retrieval_precision", {}),
    ("retrieval_precision", {"k": 3}),
    ("retrieval_precision", {"k": 40}),
    ("retrieval_precision", {"k": 40, "adaptive_k": True}),
    ("retrieval_recall", {}),
    ("retrieval_recall", {"k": 2}),
    ("retrieval_fall_out", {}),
    ("retrieval_fall_out", {"k": 4}),
    ("retrieval_hit_rate", {}),
    ("retrieval_hit_rate", {"k": 1}),
    ("retrieval_normalized_dcg", {}),
    ("retrieval_normalized_dcg", {"k": 5}),
    ("retrieval_precision_recall_curve", {}),
    ("retrieval_precision_recall_curve", {"max_k": 7}),
    ("retrieval_precision_recall_curve", {"max_k": 40}),
    ("retrieval_precision_recall_curve", {"max_k": 40, "adaptive_k": True}),
]


@pytest.mark.parametrize("target_dtype", [np.int32, np.int64, np.bool_])
@pytest.mark.parametrize("fn,kw", FUNCTIONALS, ids=[f"{f}-{k}" for f, k in FUNCTIONALS])
def test_functionals_match_jax(fn, kw, target_dtype):
    """Eight queries of 1-30 documents with tied scores, one without a
    positive and one without a negative target (four lengths, so the JAX
    package's traces are reused)."""
    rng = np.random.default_rng(len(fn) + len(kw))
    for q in range(8):
        preds, target = _query(rng, (1, 5, 12, 30)[q % 4], target_dtype=target_dtype)
        if q == 0:
            target[:] = 0
        if q == 1:
            target[:] = 1
        j, t = both(preds, target)
        close(getattr(torch_fn, fn)(*t, **kw), getattr(jax_fn, fn)(*j, **kw))


@pytest.mark.parametrize("k", [None, 1, 4])
def test_ndcg_on_graded_targets_matches_jax(k):
    rng = np.random.default_rng(11)
    for q in range(8):
        preds, target = _query(rng, (5, 12, 30, 2)[q % 4], graded=True)
        j, t = both(preds, target)
        close(torch_fn.retrieval_normalized_dcg(*t, k=k), jax_fn.retrieval_normalized_dcg(*j, k=k))


def test_tied_scores_rank_in_input_order_like_jax():
    """All scores tied (and -0.0 beside 0.0): the ranking is the input order,
    so precision@1, reciprocal rank and nDCG follow where the hit sits."""
    for target in ([0, 0, 1, 0], [1, 0, 0, 0], [0, 1, 1, 0]):
        for preds in ([0.5] * 4, [0.0, -0.0, 0.0, -0.0], [-0.0, 0.0, -0.0, 0.0]):
            j, t = both(np.array(preds, np.float32), np.array(target, np.int32))
            for fn, kw in (("retrieval_precision", {"k": 1}), ("retrieval_reciprocal_rank", {}),
                           ("retrieval_normalized_dcg", {}), ("retrieval_average_precision", {}),
                           ("retrieval_precision_recall_curve", {"max_k": 3})):
                close(getattr(torch_fn, fn)(*t, **kw), getattr(jax_fn, fn)(*j, **kw))


def test_functional_errors_match_jax_types():
    f32, i32 = np.float32, np.int32
    cases = [
        ("retrieval_precision", (np.zeros(3, f32), np.zeros(4, i32)), {}),
        ("retrieval_precision", (np.zeros(0, f32), np.zeros(0, i32)), {}),
        ("retrieval_recall", (np.zeros(3, i32), np.zeros(3, i32)), {}),
        ("retrieval_recall", (np.zeros(3, f32), np.zeros(3, f32)), {}),
        ("retrieval_average_precision", (np.zeros(3, f32), np.array([0, 2, 1], i32)), {}),
        ("retrieval_precision", (np.zeros(3, f32), np.zeros(3, i32)), {"k": 0}),
        ("retrieval_hit_rate", (np.zeros(3, f32), np.zeros(3, i32)), {"k": 1.5}),
        ("retrieval_precision", (np.zeros(3, f32), np.zeros(3, i32)), {"adaptive_k": 1}),
        ("retrieval_precision_recall_curve", (np.zeros(3, f32), np.zeros(3, i32)), {"max_k": -1}),
        ("retrieval_precision_recall_curve", (np.zeros(3, f32), np.zeros(3, i32)), {"adaptive_k": "no"}),
    ]
    for fn, arrays, kw in cases:
        j, t = both(*arrays)
        with pytest.raises(ValueError):
            getattr(jax_fn, fn)(*j, **kw)
        with pytest.raises(ValueError):
            getattr(torch_fn, fn)(*t, **kw)


# --------------------------------------------------------------------------- modules

MODULES = [
    ("RetrievalMAP", {}),
    ("RetrievalMRR", {}),
    ("RetrievalPrecision", {}),
    ("RetrievalPrecision", {"k": 3}),
    ("RetrievalPrecision", {"k": 12, "adaptive_k": True}),
    ("RetrievalRecall", {"k": 2}),
    ("RetrievalFallOut", {"k": 3}),
    ("RetrievalHitRate", {"k": 2}),
    ("RetrievalRPrecision", {}),
    ("RetrievalNormalizedDCG", {}),
    ("RetrievalNormalizedDCG", {"k": 3}),
    ("RetrievalPrecisionRecallCurve", {}),
    ("RetrievalPrecisionRecallCurve", {"max_k": 5, "adaptive_k": True}),
    ("RetrievalRecallAtFixedPrecision", {"min_precision": 0.3}),
    ("RetrievalRecallAtFixedPrecision", {"min_precision": 0.8, "max_k": 6}),
]
ACTIONS = ["neg", "pos", "skip"]


def _batches(rng, graded=False, target_dtype=np.int32, updates=3, queries=9):
    """``updates`` batches over ``queries`` query ids (a query's documents
    spread across batches, ids unsorted), query 0 with no positive target,
    query 1 with no negative target. The batch lengths are fixed, so the JAX
    package's traces are reused."""
    out = []
    for u in range(updates):
        n = (24, 32, 40)[u % 3]
        idx = rng.integers(0, queries, n).astype(np.int64)
        preds, target = _query(rng, n, graded=graded, target_dtype=target_dtype)
        target[idx == 0] = 0
        target[idx == 1] = 1
        out.append((preds, target, idx))
    return out


def _states_equal(tm, jm):
    for key in jm._defaults:
        jv, tv = getattr(jm, key), getattr(tm, key)
        assert len(tv) == len(jv), key
        for a, b in zip(tv, jv):
            close(a, b)


def _run_modules(cls, kw, batches):
    jm, tm = getattr(jax_ret, cls)(**kw), getattr(torch_ret, cls)(**kw, **CPU)
    for i, (preds, target, idx) in enumerate(batches):
        j, t = both(preds, target, idx)
        if i == 1:
            close(tm.forward(t[0], t[1], indexes=t[2]), jm.forward(j[0], j[1], indexes=j[2]))
        else:
            jm.update(j[0], j[1], indexes=j[2])
            tm.update(t[0], t[1], indexes=t[2])
        _states_equal(tm, jm)
    close(tm.compute(), jm.compute())
    return jm, tm


@pytest.mark.parametrize("action", ACTIONS)
@pytest.mark.parametrize("cls,kw", MODULES, ids=[f"{c}-{k}" for c, k in MODULES])
def test_modules_match_jax(cls, kw, action):
    rng = np.random.default_rng(len(cls) + 7 * ACTIONS.index(action) + len(kw))
    graded = cls == "RetrievalNormalizedDCG"
    _run_modules(cls, {**kw, "empty_target_action": action}, _batches(rng, graded=graded))


@pytest.mark.parametrize("target_dtype", [np.int64, np.bool_])
@pytest.mark.parametrize("cls", ["RetrievalMAP", "RetrievalPrecisionRecallCurve"])
def test_target_dtypes_match_jax(cls, target_dtype):
    rng = np.random.default_rng(5)
    _run_modules(cls, {}, _batches(rng, target_dtype=target_dtype))


@pytest.mark.parametrize("score_dtype", [np.float64, np.float16])
def test_score_dtypes_match_jax(score_dtype):
    """float64 and float16 scores become float32 states and values (ROADMAP
    C.8), as the JAX package casts them; functionals the same."""
    rng = np.random.default_rng(12)
    batches = [(p.astype(score_dtype), t, i) for p, t, i in _batches(rng)]
    jm, tm = _run_modules("RetrievalMAP", {}, batches)
    assert all(p.dtype == torch.float32 for p in tm.preds)
    preds, target = _query(rng, 30)
    j, t = both(preds.astype(score_dtype), target)
    for fn in ("retrieval_average_precision", "retrieval_normalized_dcg", "retrieval_precision_recall_curve"):
        close(getattr(torch_fn, fn)(*t), getattr(jax_fn, fn)(*j))


@pytest.mark.parametrize("cls", ["RetrievalMAP", "RetrievalMRR", "RetrievalNormalizedDCG", "RetrievalFallOut",
                                 "RetrievalPrecisionRecallCurve"])
def test_ignore_index_matches_jax(cls):
    """Documents whose target is ``ignore_index`` (-1 here) are dropped in
    both packages before the binary check."""
    rng = np.random.default_rng(6)
    batches = []
    for preds, target, idx in _batches(rng):
        target = np.where(rng.random(target.shape[0]) < 0.2, -1, target).astype(np.int32)
        batches.append((preds, target, idx))
    _run_modules(cls, {"ignore_index": -1}, batches)


@pytest.mark.parametrize("cls", ["RetrievalMAP", "RetrievalFallOut", "RetrievalPrecisionRecallCurve"])
def test_error_action_raises_on_an_empty_query_like_jax(cls):
    rng = np.random.default_rng(8)
    batches = _batches(rng, updates=1)
    preds, target, idx = batches[0]
    jm, tm = getattr(jax_ret, cls)(empty_target_action="error"), getattr(torch_ret, cls)(
        empty_target_action="error", **CPU)
    j, t = both(preds, target, idx)
    jm.update(j[0], j[1], indexes=j[2])
    tm.update(t[0], t[1], indexes=t[2])
    with pytest.raises(ValueError, match="no (positive|negative) target"):
        jm.compute()
    with pytest.raises(ValueError, match="no (positive|negative) target"):
        tm.compute()
    # without the empty queries, both compute the same value
    has_pos = np.array([target[idx == q].any() for q in idx])
    has_neg = np.array([not target[idx == q].all() for q in idx])
    keep = has_pos & has_neg
    jm, tm = getattr(jax_ret, cls)(empty_target_action="error"), getattr(torch_ret, cls)(
        empty_target_action="error", **CPU)
    j, t = both(preds[keep], target[keep], idx[keep])
    jm.update(j[0], j[1], indexes=j[2])
    tm.update(t[0], t[1], indexes=t[2])
    close(tm.compute(), jm.compute())


def test_query_ids_keep_their_low_word_like_jax():
    """int64 query ids at and above 2^31 become int32 by their low 32 bits, as
    ``jnp.asarray`` makes them with x64 off (ROADMAP C.3): 2^32 + 5 is query 5,
    2^31 is query -2^31."""
    preds = np.array([0.9, 0.1, 0.5, 0.7, 0.3, 0.2], np.float32)
    target = np.array([1, 0, 0, 1, 1, 0], np.int32)
    idx = np.array([5, 2**32 + 5, 2**31, 2**31, 7, 7], np.int64)
    jm, tm = jax_ret.RetrievalMAP(), torch_ret.RetrievalMAP(**CPU)
    j, t = both(preds, target, idx)
    jm.update(j[0], j[1], indexes=j[2])
    tm.update(t[0], t[1], indexes=t[2])
    assert tm.indexes[0].tolist() == [5, 5, -2**31, -2**31, 7, 7]
    _states_equal(tm, jm)
    close(tm.compute(), jm.compute())


def test_grouping_matches_jax():
    """Query ids, ranks, per-query counts and cumulative hits of
    ``group_by_query`` on tied scores equal the JAX package's."""
    rng = np.random.default_rng(9)
    preds, target, idx = _batches(rng, updates=1, queries=6)[0]
    idx = idx.astype(np.int32)
    j, t = both(idx, preds, target)
    jg, tg = jax_ret.group_by_query(*j), torch_ret.group_by_query(*t)
    assert tg.num_queries == jg.num_queries
    for name in ("seg", "rank"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)))
    for name in ("preds", "target", "n_per", "pos_per", "neg_per", "cum_hits", "ideal_target"):
        close(getattr(tg, name), getattr(jg, name))


def test_module_errors_match_jax_types():
    f32, i32 = np.float32, np.int32
    update_cases = [
        ((np.zeros(3, f32), np.zeros(3, i32), None), ValueError),
        ((np.zeros(3, f32), np.zeros(3, i32), np.zeros(4, i32)), IndexError),
        ((np.zeros(3, f32), np.zeros(3, i32), np.zeros(3, f32)), ValueError),
        ((np.zeros(3, i32), np.zeros(3, i32), np.zeros(3, i32)), ValueError),
        ((np.zeros(3, f32), np.zeros(3, f32), np.zeros(3, i32)), ValueError),
        ((np.zeros(3, f32), np.array([0, 3, 1], i32), np.zeros(3, i32)), ValueError),
        ((np.zeros((), f32), np.zeros((), i32), np.zeros((), i32)), ValueError),
    ]
    for arrays, err in update_cases:
        j, t = both(*arrays)
        with pytest.raises(err):
            jax_ret.RetrievalMAP().update(j[0], j[1], indexes=j[2])
        with pytest.raises(err):
            torch_ret.RetrievalMAP(**CPU).update(t[0], t[1], indexes=t[2])
    for cls, kw in (("RetrievalMAP", {"empty_target_action": "drop"}), ("RetrievalMRR", {"ignore_index": 1.5}),
                    ("RetrievalPrecision", {"k": 0}), ("RetrievalPrecision", {"adaptive_k": 1}),
                    ("RetrievalRecall", {"k": -2}), ("RetrievalPrecisionRecallCurve", {"max_k": 0}),
                    ("RetrievalPrecisionRecallCurve", {"adaptive_k": None}),
                    ("RetrievalRecallAtFixedPrecision", {"min_precision": 1.5}),
                    ("RetrievalRecallAtFixedPrecision", {"min_precision": 1})):
        with pytest.raises(ValueError):
            getattr(jax_ret, cls)(**kw)
        with pytest.raises(ValueError):
            getattr(torch_ret, cls)(**kw, **CPU)


@pytest.mark.parametrize("module", ["metrics_tpu_torch.functional.retrieval.rank_metrics",
                                    "metrics_tpu_torch.retrieval.rank_metrics",
                                    "metrics_tpu_torch.retrieval.precision_recall_curve"])
def test_docstring_examples_run(module):
    result = doctest.testmod(importlib.import_module(module), verbose=False)
    assert result.attempted > 0 and result.failed == 0
