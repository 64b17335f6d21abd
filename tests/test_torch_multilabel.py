"""The port's multilabel stat-score family (functional and module) against the
JAX package's, on the CPU.

Every family (stat scores, confusion matrix, accuracy, F1, F-beta, precision,
recall, specificity) runs over the same numpy batches in both packages, for
every ``average`` (micro, macro, weighted, "none", None): float probabilities
and logits (through the sigmoid), int32, int64 and bool labels,
``ignore_index`` None, -1 and 1, and ``multidim_average`` "global" (N = 16,
C = 5) and "samplewise" (N = 6, C = 5, 4 positions a sample). Every count
state is int32 and bit-identical (``(C,)`` tensors, samplewise list entries,
the ``(C, 2, 2)`` tables); values agree within rtol=1e-6 (float32 divisions
of int32 counts and a float sum over at most 5 labels, in other orders).
Errors are of the JAX package's types.
"""

import numpy as np
import pytest

import metrics_tpu.classification as jax_cls
import metrics_tpu.functional.classification as jax_fn
from metrics_tpu.collections import MetricCollection as JaxCollection
import metrics_tpu_torch.classification as torch_cls
import metrics_tpu_torch.functional.classification as torch_fn
from metrics_tpu_torch.collections import MetricCollection
from tests.test_torch_binary import CPU, FAMILIES, both, close, run_family

L = 5
SHAPES = {"global": (16, L), "samplewise": (6, L, 4)}
KINDS = {"probs": np.int32, "logits": np.int32, "int32": np.int32, "int64": np.int64, "bool": np.bool_}
CASES = [("probs", None), ("probs", -1), ("logits", 1), ("int32", None), ("int32", -1), ("int64", 1), ("bool", None),
         ("bool", 1)]
AVERAGES = ["micro", "macro", "weighted", "none", None]


def multilabel_batch(rng, shape, kind, ignore_index):
    target = rng.integers(0, 2, shape)
    if ignore_index is not None:
        target[rng.random(shape) < 0.2] = ignore_index
    target = target.astype(KINDS[kind])
    if kind == "probs":
        preds = rng.random(shape).astype(np.float32)
    elif kind == "logits":
        preds = rng.normal(0.0, 2.0, shape).astype(np.float32)
    else:
        preds = rng.integers(0, 2, shape).astype(KINDS[kind])
    return preds, target


@pytest.mark.parametrize("mda", ["global", "samplewise"])
@pytest.mark.parametrize("kind,ignore_index", CASES)
def test_multilabel_family_matches_jax(kind, ignore_index, mda):
    rng = np.random.default_rng(sum(map(ord, f"ml{kind}{ignore_index}{mda}")))
    batches = [multilabel_batch(rng, SHAPES[mda], kind, ignore_index) for _ in range(2)]
    threshold = 0.3 if kind == "logits" else 0.5
    for average in AVERAGES:
        args = {"threshold": threshold, "average": average, "multidim_average": mda, "ignore_index": ignore_index}
        for family in FAMILIES:
            run_family("multilabel", family, args, batches, num_labels=L)


@pytest.mark.parametrize("normalize", [None, "none", "true", "pred", "all"])
@pytest.mark.parametrize("kind,ignore_index", [("probs", None), ("logits", -1), ("int64", 1), ("bool", 0)])
def test_multilabel_confusion_matrix_matches_jax(kind, ignore_index, normalize):
    rng = np.random.default_rng(sum(map(ord, f"mlcm{kind}{ignore_index}{normalize}")))
    batches = [multilabel_batch(rng, SHAPES["global"], kind, ignore_index) for _ in range(2)]
    run_family("multilabel", ("confusion_matrix", "ConfusionMatrix", {}),
               {"ignore_index": ignore_index, "normalize": normalize}, batches, num_labels=L)


def test_values_outside_the_labels_count_like_jax_without_validation():
    rng = np.random.default_rng(4)
    preds = rng.integers(-2, 3, SHAPES["global"]).astype(np.int32)
    target = rng.integers(-1, 3, SHAPES["global"]).astype(np.int32)
    jb, tb = both((preds, target))
    for ignore_index in (None, 2):
        kw = {"ignore_index": ignore_index, "validate_args": False}
        close(torch_fn.multilabel_stat_scores(*tb, L, **kw), jax_fn.multilabel_stat_scores(*jb, L, **kw))
        close(torch_fn.multilabel_confusion_matrix(*tb, L, **kw), jax_fn.multilabel_confusion_matrix(*jb, L, **kw))


def _bad_multilabel():
    f32, i32 = np.float32, np.int32
    return {
        "shape": (np.zeros((4, L), f32), np.zeros((4, L + 1), i32), {}),
        "num_labels": (np.zeros((4, L + 1), f32), np.zeros((4, L + 1), i32), {}),
        "float_target": (np.zeros((4, L), f32), np.zeros((4, L), f32), {}),
        "target_values": (np.zeros((4, L), f32), np.full((4, L), 2, i32), {}),
        "samplewise_2d": (np.zeros((4, L), f32), np.zeros((4, L), i32), {"multidim_average": "samplewise"}),
        "empty": (np.zeros((0, L), f32), np.zeros((0, L), i32), {}),
        "threshold": (np.zeros((4, L), f32), np.zeros((4, L), i32), {"threshold": 0}),
        "average": (np.zeros((4, L), f32), np.zeros((4, L), i32), {"average": "samples"}),
        "multidim_average": (np.zeros((4, L), f32), np.zeros((4, L), i32), {"multidim_average": "all"}),
        "ignore_index": (np.zeros((4, L), f32), np.zeros((4, L), i32), {"ignore_index": 1.0}),
    }


@pytest.mark.parametrize("case", sorted(_bad_multilabel()))
def test_bad_multilabel_input_raises_the_jax_type(case):
    preds, target, kw = _bad_multilabel()[case]
    jb, tb = both((preds, target))
    for name in ("stat_scores", "f1_score", "specificity"):
        with pytest.raises(Exception) as want:
            getattr(jax_fn, f"multilabel_{name}")(*jb, L, **kw)
        with pytest.raises(want.type):
            getattr(torch_fn, f"multilabel_{name}")(*tb, L, **kw)
    with pytest.raises(Exception) as want:
        jax_cls.MultilabelRecall(L, **kw).update(*jb)
    with pytest.raises(want.type):
        torch_cls.MultilabelRecall(L, **kw, **CPU).update(*tb)


def test_num_labels_below_two_raises_the_jax_type():
    with pytest.raises(ValueError):
        jax_cls.MultilabelAccuracy(1)
    with pytest.raises(ValueError):
        torch_cls.MultilabelAccuracy(1, **CPU)


def _multilabel_five(pkg, **kw):
    return {"acc": pkg.MultilabelAccuracy(L, **kw), "f1": pkg.MultilabelF1Score(L, **kw),
            "prec": pkg.MultilabelPrecision(L, **kw), "rec": pkg.MultilabelRecall(L, **kw),
            "spec": pkg.MultilabelSpecificity(L, **kw)}


def test_multilabel_collection_forms_the_jax_compute_groups():
    jcol, tcol = JaxCollection(_multilabel_five(jax_cls)), MetricCollection(_multilabel_five(torch_cls, **CPU))
    assert tcol.compute_groups == jcol.compute_groups
    rng = np.random.default_rng(12)
    for _ in range(2):
        jb, tb = both(multilabel_batch(rng, SHAPES["global"], "probs", None))
        jcol.update(*jb)
        tcol.update(*tb)
        assert tcol.compute_groups == jcol.compute_groups
    assert len(tcol.compute_groups) == 1
    got, want = tcol.compute(), jcol.compute()
    assert list(got) == list(want)
    for key in want:
        close(got[key], want[key])
