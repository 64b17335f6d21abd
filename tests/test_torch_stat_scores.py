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


# --------------------------------------------------------------- the stat-score route
#
# The global label route of ``_multiclass_stat_scores_update`` counts tp/fp/tn/fn
# without the (C, C) table on the card (``csrc/pair_count.cu``'s stat-score route)
# and derives them from the bincount table on the CPU. Both are held bit for bit
# (int32 values and dtype) against the JAX package's update, against the counts
# derived from its Pallas kernel in interpret mode, and against a torch emulation
# of the kernel's per-pair arithmetic.

from metrics_tpu.functional.classification.confusion_matrix import (  # noqa: E402
    _multiclass_confusion_matrix_update as jax_cm_update,
)
from metrics_tpu.functional.classification.stat_scores import (  # noqa: E402
    _multiclass_stat_scores_update as jax_stat_scores_update,
)
from metrics_tpu.kernels import confmat as jax_confmat  # noqa: E402
from metrics_tpu_torch.functional.classification.confusion_matrix import (  # noqa: E402
    _multiclass_confusion_matrix_update,
)
from metrics_tpu_torch.functional.classification.stat_scores import _multiclass_stat_scores_update  # noqa: E402
from metrics_tpu_torch.kernels import confmat  # noqa: E402


def _low_words(x: torch.Tensor) -> torch.Tensor:
    """Flat labels as the kernel loads them: an int64 label's low 32-bit word
    (the first of its two, little-endian), an int32 label as it is."""
    flat = x.reshape(-1).contiguous()
    return flat.view(torch.int32)[::2] if flat.dtype == torch.int64 else flat.to(torch.int32)


def _kernel_emulation(target, preds, num_classes, ignore_index):
    """The stat-score kernel's arithmetic in torch: each valid pair (t, p) adds 1
    to tp[t] if t == p, else 1 to fn[t] and 1 to fp[p]; tn = n_valid - tp - fn - fp."""
    t, p = _low_words(target), _low_words(preds)
    valid = (t >= 0) & (t < num_classes) & (p >= 0) & (p < num_classes)
    if ignore_index is not None:
        valid &= t.to(torch.int64) != ignore_index
    t, p = t[valid].to(torch.int64), p[valid].to(torch.int64)
    hit = t == p

    def count(idx):
        return torch.zeros(num_classes, dtype=torch.int32).index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))

    tp, fn, fp = count(t[hit]), count(t[~hit]), count(p[~hit])
    n_valid = torch.tensor(int(valid.sum()), dtype=torch.int32)
    return tp, fp, n_valid - tp - fn - fp, fn


def _pallas_stat_scores(jt, jp, num_classes, ignore_index):
    """tp/fp/tn/fn from the JAX package's Pallas pair count (interpret mode),
    with the diag and sums of its stat-score fast path."""
    mask = jt != ignore_index if ignore_index is not None else jnp.ones(jt.shape, bool)
    t = jnp.where(mask, jt, 0).astype(jnp.int32)
    cm = jax_confmat.pair_count_fused(t, jp.astype(jnp.int32), num_classes, num_classes, mask, interpret=True)
    tp = jnp.diag(cm)
    fn = jnp.sum(cm, axis=1) - tp
    fp = jnp.sum(cm, axis=0) - tp
    tn = jnp.sum(cm) - tp - fn - fp
    return tuple(x.astype(jnp.int32) for x in (tp, fp, tn, fn))


def _assert_stat_scores_agree(preds, target, num_classes, ignore_index, pallas=True):
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    want = jax_stat_scores_update(jp, jt, num_classes, 1, "macro", "global", ignore_index)
    got = {
        "update": _multiclass_stat_scores_update(tp, tt, num_classes, 1, "macro", "global", ignore_index),
        "stat_scores_bincount": confmat.stat_scores_bincount(tt, tp, num_classes, ignore_index),
        "stat_scores": confmat.stat_scores(tt, tp, num_classes, ignore_index),
        "stat_scores_cuda_on_cpu": confmat.stat_scores_cuda(tt, tp, num_classes, ignore_index),
        "kernel_emulation": _kernel_emulation(tt, tp, num_classes, ignore_index),
    }
    if pallas:
        got["pallas"] = _pallas_stat_scores(jt, jp, num_classes, ignore_index)
    for name, counts in got.items():
        for what, w, g in zip("tp fp tn fn".split(), want, counts):
            g = torch.from_numpy(np.array(g)) if not isinstance(g, torch.Tensor) else g
            assert g.dtype == torch.int32 and np.asarray(w).dtype == np.int32, (name, what, g.dtype)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{name}.{what}")
    # the table route on the same pairs, against the JAX package's confusion-matrix update
    want_cm = np.asarray(jax_cm_update(jp, jt, num_classes, ignore_index))
    got_cm = _multiclass_confusion_matrix_update(tp, tt, num_classes, ignore_index)
    assert got_cm.dtype == torch.int32
    np.testing.assert_array_equal(got_cm.numpy(), want_cm)


_IGNORE = {"none": lambda c: None, "in_range": lambda c: c // 2, "minus_one": lambda c: -1, "above": lambda c: c + 3}


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("ignore", sorted(_IGNORE))
@pytest.mark.parametrize("num_classes", [2, 7, 100])
def test_stat_score_route_matches_jax(num_classes, ignore, dtype):
    """In-range labels with the ignored index and out-of-range and negative
    labels mixed in (``validate_args=False`` lets them through), ragged N."""
    ignore_index = _IGNORE[ignore](num_classes)
    rng = np.random.default_rng(num_classes * 10 + len(ignore) + (dtype == np.int64))
    n = int(rng.integers(300, 1100))
    target = rng.integers(0, num_classes, n)
    preds = np.where(rng.random(n) < 0.4, target, rng.integers(0, num_classes, n))  # a diagonal share
    if ignore_index is not None:
        target = np.where(rng.random(n) < 0.15, ignore_index, target)
    target = np.where(rng.random(n) < 0.05, rng.integers(-3, num_classes + 3, n), target)
    preds = np.where(rng.random(n) < 0.05, rng.integers(-3, num_classes + 3, n), preds)
    _assert_stat_scores_agree(preds.astype(dtype), target.astype(dtype), num_classes, ignore_index)


@pytest.mark.parametrize("ignore_index", [None, 3, -1, 7])
def test_stat_score_route_reads_the_low_word_of_int64_labels_like_jax(ignore_index):
    """int64 labels at and above 2**31 count by their low 32 bits, as the JAX
    package sees them with x64 off: 2**32 + 3 is class 3 (and ignored when
    ``ignore_index`` is 3), 2**31 + 3 is negative and dropped."""
    rng = np.random.default_rng(23 + (ignore_index or 0))
    n = 517
    target = rng.integers(0, 7, n).astype(np.int64)
    preds = rng.integers(0, 7, n).astype(np.int64)
    high = rng.random(n) < 0.3
    target = np.where(high, target + rng.choice([2**32, 2**33, 2**31, -(2**32)], n), target)
    preds = np.where(rng.random(n) < 0.3, preds + rng.choice([2**32, 2**31, 2**40], n), preds)
    assert (target >= 2**31).any() and (preds >= 2**31).any()
    _assert_stat_scores_agree(preds, target, 7, ignore_index)


@pytest.mark.parametrize("case", ["valid", "hit", "ignored", "out_of_range"])
@pytest.mark.parametrize("num_classes", [2, 7, 100])
def test_stat_score_route_single_pair(num_classes, case):
    target, preds = {"valid": (1, 0), "hit": (1, 1), "ignored": (1, 1), "out_of_range": (num_classes, 0)}[case]
    ignore_index = 1 if case == "ignored" else None
    _assert_stat_scores_agree(np.array([preds], np.int64), np.array([target], np.int64), num_classes, ignore_index)


@pytest.mark.parametrize("target_dtype,preds_dtype", [(np.int32, np.int64), (np.int64, np.int32), (np.uint8, np.int64)])
def test_stat_score_route_takes_mixed_label_types(target_dtype, preds_dtype):
    rng = np.random.default_rng(41)
    target = rng.integers(0, 9, 1031).astype(target_dtype)
    preds = rng.integers(0, 9, 1031).astype(preds_dtype)
    _assert_stat_scores_agree(preds, target, 9, 4)


def test_stat_score_route_on_a_view_at_a_storage_offset():
    """The kernel loads 16 bytes at a time only from aligned arrays; a view that
    starts one label in reads label by label. On the CPU the plain version and
    the emulation see the same view."""
    rng = np.random.default_rng(43)
    base_t = torch.from_numpy(rng.integers(0, 11, 2053))
    base_p = torch.from_numpy(rng.integers(0, 11, 2053))
    tt, tp = base_t[1:2050], base_p[3:2052]
    assert tt.storage_offset() == 1 and tp.storage_offset() == 3
    want = jax_stat_scores_update(jnp.asarray(tp.numpy()), jnp.asarray(tt.numpy()), 11, 1, "macro", "global", 5)
    for got in (confmat.stat_scores_bincount(tt, tp, 11, 5), _kernel_emulation(tt, tp, 11, 5),
                _multiclass_stat_scores_update(tp, tt, 11, 1, "macro", "global", 5)):
        for w, g in zip(want, got):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("ignore_index", [None, 3])
def test_one_hot_route_reads_the_low_word_of_int64_labels_like_jax(ignore_index):
    """The samplewise (one-hot) route counts int64 labels by their low 32 bits
    too, so both routes agree with the JAX package on labels at and above 2**31."""
    rng = np.random.default_rng(61 + (ignore_index or 0))
    target = rng.integers(0, NUM_CLASSES, (N, X)) + rng.choice([0, 2**32, 2**31], (N, X))
    preds = rng.integers(0, NUM_CLASSES, (N, X)) + rng.choice([0, 2**32, 2**33], (N, X))
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    for mda in ("global", "samplewise"):
        want = jax_multiclass_stat_scores(jp, jt, NUM_CLASSES, None, 1, mda, ignore_index, validate_args=False)
        got = multiclass_stat_scores(tp, tt, NUM_CLASSES, None, 1, mda, ignore_index, validate_args=False)
        _assert_same(want, got)
