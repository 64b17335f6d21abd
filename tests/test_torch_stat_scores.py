"""The port's multiclass stat-scores and confusion-matrix functionals against
the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both. Counts must match
exactly, int32 included; normalised confusion matrices and the derived
accuracy/F-beta values within rtol=1e-6 (float32 division and a float sum
over classes). Validation errors must raise the same exception types.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.functional.classification.accuracy import multiclass_accuracy as jax_multiclass_accuracy
from metrics_tpu.functional.classification.confusion_matrix import (
    multiclass_confusion_matrix as jax_multiclass_confusion_matrix,
)
from metrics_tpu.functional.classification.f_beta import multiclass_f1_score as jax_multiclass_f1_score
from metrics_tpu.functional.classification.f_beta import multiclass_fbeta_score as jax_multiclass_fbeta_score
from metrics_tpu.functional.classification.stat_scores import multiclass_stat_scores as jax_multiclass_stat_scores
from metrics_tpu_torch.functional.classification import (
    multiclass_accuracy,
    multiclass_confusion_matrix,
    multiclass_f1_score,
    multiclass_fbeta_score,
    multiclass_stat_scores,
)

NUM_CLASSES = 5
N = 57  # odd sizes: no tile-multiple luck
X = 3


def _inputs(kind, seed, ignore_index):
    rng = np.random.default_rng(seed)
    extra = (X,) if kind.endswith("_md") else ()
    target = rng.integers(0, NUM_CLASSES, (N, *extra))
    if ignore_index is not None:
        target = np.where(rng.random(target.shape) < 0.2, ignore_index, target)
    if kind.startswith("labels"):
        preds = rng.integers(0, NUM_CLASSES, (N, *extra))
    else:
        preds = rng.standard_normal((N, NUM_CLASSES, *extra)).astype(np.float32)
    return preds, target


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _assert_same(want, got, exact=True):
    want = np.asarray(want)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype), (got.dtype, want.dtype)
    if exact:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


_CASES = [
    (kind, top_k, mda)
    for kind in ("labels", "probs", "labels_md", "probs_md")
    for top_k in (1, 3)
    for mda in ("global", "samplewise")
    if (top_k == 1 or kind.startswith("probs")) and (mda == "global" or kind.endswith("_md"))
]


@pytest.mark.parametrize("kind,top_k,mda", _CASES)
@pytest.mark.parametrize("ignore_index", [None, 2])
def test_multiclass_stat_scores_matches_jax(kind, top_k, mda, ignore_index):
    preds, target = _inputs(kind, seed=len(kind) + top_k, ignore_index=ignore_index)
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    for average in ("micro", "macro", "weighted", "none", None):
        want = jax_multiclass_stat_scores(jp, jt, NUM_CLASSES, average, top_k, mda, ignore_index)
        got = multiclass_stat_scores(tp, tt, NUM_CLASSES, average, top_k, mda, ignore_index)
        _assert_same(want, got)


@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none", None])
@pytest.mark.parametrize("kind,top_k", [("labels", 1), ("probs", 3), ("probs_md", 1)])
def test_multiclass_accuracy_and_fbeta_match_jax(average, kind, top_k):
    preds, target = _inputs(kind, seed=7, ignore_index=0)
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    args = (NUM_CLASSES, average, top_k, "global", 0)
    _assert_same(jax_multiclass_accuracy(jp, jt, *args), multiclass_accuracy(tp, tt, *args), exact=False)
    _assert_same(jax_multiclass_f1_score(jp, jt, *args), multiclass_f1_score(tp, tt, *args), exact=False)
    _assert_same(
        jax_multiclass_fbeta_score(jp, jt, 0.5, *args), multiclass_fbeta_score(tp, tt, 0.5, *args), exact=False
    )


@pytest.mark.parametrize("normalize", [None, "none", "true", "pred", "all"])
@pytest.mark.parametrize("kind,ignore_index", [("labels", None), ("probs", 1), ("labels_md", 4)])
def test_multiclass_confusion_matrix_matches_jax(normalize, kind, ignore_index):
    preds, target = _inputs(kind, seed=3, ignore_index=ignore_index)
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    want = jax_multiclass_confusion_matrix(jp, jt, NUM_CLASSES, ignore_index, normalize)
    got = multiclass_confusion_matrix(tp, tt, NUM_CLASSES, ignore_index, normalize)
    _assert_same(want, got, exact=normalize in (None, "none"))


def test_out_of_range_labels_drop_the_pair_without_validation():
    rng = np.random.default_rng(8)
    preds = rng.integers(-2, NUM_CLASSES + 2, 200)
    target = rng.integers(-2, NUM_CLASSES + 2, 200)
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    _assert_same(
        jax_multiclass_stat_scores(jp, jt, NUM_CLASSES, None, validate_args=False),
        multiclass_stat_scores(tp, tt, NUM_CLASSES, None, validate_args=False),
    )
    _assert_same(
        jax_multiclass_confusion_matrix(jp, jt, NUM_CLASSES, validate_args=False),
        multiclass_confusion_matrix(tp, tt, NUM_CLASSES, validate_args=False),
    )


def _raised(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — the type is what is compared
        return type(exc)
    return None


_BAD_ARGS = [
    dict(num_classes=1),
    dict(num_classes=2.0),
    dict(top_k=0),
    dict(top_k=NUM_CLASSES + 1),
    dict(average="samples"),
    dict(multidim_average="perclass"),
    dict(ignore_index=1.5),
]


@pytest.mark.parametrize("bad", _BAD_ARGS, ids=lambda d: next(iter(d)))
def test_argument_validation_raises_the_same_type(bad):
    kw = dict(num_classes=NUM_CLASSES, top_k=1, average="macro", multidim_average="global", ignore_index=None)
    kw.update(bad)
    preds, target = _inputs("probs", seed=1, ignore_index=None)
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    want = _raised(lambda: jax_multiclass_stat_scores(jp, jt, **kw))
    got = _raised(lambda: multiclass_stat_scores(tp, tt, **kw))
    assert want is not None and got is want


def _bad_tensors():
    rng = np.random.default_rng(2)
    labels = rng.integers(0, NUM_CLASSES, N)
    probs = rng.standard_normal((N, NUM_CLASSES)).astype(np.float32)
    return {
        "float_preds_same_shape": (probs[:, 0], labels, "global"),
        "int_preds_extra_dim": (rng.integers(0, NUM_CLASSES, (N, NUM_CLASSES)), labels, "global"),
        "wrong_class_dim": (probs[:, :3], labels, "global"),
        "shape_mismatch": (labels[:-1], labels, "global"),
        "ndim_gap_of_two": (probs[:, :, None, None], labels, "global"),
        "samplewise_1d": (labels, labels, "samplewise"),
        "target_out_of_range": (labels, labels + NUM_CLASSES, "global"),
        "negative_target": (labels, labels - NUM_CLASSES, "global"),
        "preds_out_of_range": (labels + NUM_CLASSES, labels, "global"),
        # an empty batch: JAX raises ValueError (the minimum of an empty target) without
        # ignore_index, and ZeroDivisionError (jnp.reshape(x, (0, -1))) with it; the port
        # copies both types
        "empty_batch": (labels[:0], labels[:0], "global"),
        "empty_batch_ignore_index": (labels[:0], labels[:0], "global", 1),
        "empty_batch_probs": (probs[:0], labels[:0], "global"),
    }


@pytest.mark.parametrize("case", sorted(_bad_tensors()))
def test_tensor_validation_raises_the_same_type(case):
    preds, target, mda, *ignore = _bad_tensors()[case]
    kw = {"multidim_average": mda, "ignore_index": ignore[0] if ignore else None}
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    want = _raised(lambda: jax_multiclass_stat_scores(jp, jt, NUM_CLASSES, **kw))
    got = _raised(lambda: multiclass_stat_scores(tp, tt, NUM_CLASSES, **kw))
    assert want is not None and got is want
    if mda == "global":
        want_cm = _raised(lambda: jax_multiclass_confusion_matrix(jp, jt, NUM_CLASSES, ignore_index=kw["ignore_index"]))
        got_cm = _raised(lambda: multiclass_confusion_matrix(tp, tt, NUM_CLASSES, ignore_index=kw["ignore_index"]))
        assert got_cm is want_cm


@pytest.mark.parametrize("validate_args", [True, False])
@pytest.mark.parametrize("ignore_index", [None, 1])
@pytest.mark.parametrize(
    "jax_fn,port_fn",
    [
        (jax_multiclass_accuracy, multiclass_accuracy),
        (jax_multiclass_f1_score, multiclass_f1_score),
        (jax_multiclass_stat_scores, multiclass_stat_scores),
        (jax_multiclass_confusion_matrix, multiclass_confusion_matrix),
    ],
    ids=["accuracy", "f1_score", "stat_scores", "confusion_matrix"],
)
def test_empty_batch_raises_the_jax_type(jax_fn, port_fn, ignore_index, validate_args):
    """``preds = target = int64 zeros(0)``: ValueError from the validation
    without ``ignore_index``, else ZeroDivisionError from the flattening, in
    both packages (JAX's ZeroDivisionError is an accident of ``jnp.reshape``
    that the port copies)."""
    empty = np.zeros(0, np.int64)
    (jp, tp), (jt, tt) = _pair(empty), _pair(empty)
    kw = {"ignore_index": ignore_index, "validate_args": validate_args}
    want = _raised(lambda: jax_fn(jp, jt, num_classes=3, **kw))
    got = _raised(lambda: port_fn(tp, tt, num_classes=3, **kw))
    assert want is (ValueError if ignore_index is None and validate_args else ZeroDivisionError)
    assert got is want


def test_invalid_normalize_raises_the_same_type():
    labels = np.arange(10) % NUM_CLASSES
    (jp, tp), (jt, tt) = _pair(labels), _pair(labels)
    want = _raised(lambda: jax_multiclass_confusion_matrix(jp, jt, NUM_CLASSES, normalize="rows"))
    got = _raised(lambda: multiclass_confusion_matrix(tp, tt, NUM_CLASSES, normalize="rows"))
    assert want is ValueError and got is ValueError
