"""The port's binary stat-score family (functional and module) and the task
façades against the JAX package's, on the CPU.

Every family (stat scores, confusion matrix, accuracy, F1, F-beta, precision,
recall, specificity) runs over the same numpy batches in both packages: float
probabilities and logits (through the sigmoid), int32, int64, bool and uint8
labels, ``ignore_index`` None, -1, 0 and 1, thresholds 0.5 and 0.3, and
``multidim_average`` "global" and "samplewise". Every count state is int32 and
bit-identical (the binary scalars of shape ``()`` and the samplewise list
entries too); values agree within rtol=1e-6 (float32 divisions of int32
counts). Errors are of the JAX package's types. Two fixed shapes, (64,) and
(8, 6), keep the JAX package's jitted updates to a few compiles.
"""

import doctest

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.classification as jax_cls
import metrics_tpu.functional.classification as jax_fn
from metrics_tpu.collections import MetricCollection as JaxCollection
import metrics_tpu_torch.classification as torch_cls
import metrics_tpu_torch.functional.classification as torch_fn
from metrics_tpu_torch.collections import MetricCollection

CPU = {"device": "cpu"}
SHAPES = {"global": (64,), "samplewise": (8, 6)}
# (functional suffix, class suffix, extra arguments); the confusion matrix has no multidim_average
FAMILIES = [
    ("stat_scores", "StatScores", {}),
    ("accuracy", "Accuracy", {}),
    ("f1_score", "F1Score", {}),
    ("fbeta_score", "FBetaScore", {"beta": 2.0}),
    ("precision", "Precision", {}),
    ("recall", "Recall", {}),
    ("specificity", "Specificity", {}),
]
# preds kind -> target dtype; bool and uint8 targets cannot hold -1
KINDS = {"probs": np.int32, "logits": np.int32, "int32": np.int32, "int64": np.int64, "bool": np.bool_,
         "uint8": np.uint8}
CASES = [(kind, ignore) for kind in KINDS for ignore in (None, -1, 0, 1)
         if not (ignore == -1 and KINDS[kind] in (np.bool_, np.uint8))]


def close(got, want):
    """int32 (and every integer and bool) outputs bit-identical with their dtype,
    float outputs within rtol=1e-6; lists and tuples entry by entry."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w)
        return
    want = np.asarray(want)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype), (got.dtype, want.dtype)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def states_equal(tm, jm):
    for key in jm._defaults:
        close(getattr(tm, key), getattr(jm, key))


def both(batch):
    """The batch as JAX arrays and as torch tensors."""
    return tuple(jnp.asarray(b) for b in batch), tuple(torch.from_numpy(np.ascontiguousarray(b)) for b in batch)


def binary_batch(rng, shape, kind, ignore_index, target_dtype=None):
    target = rng.integers(0, 2, shape)
    if ignore_index is not None:
        target[rng.random(shape) < 0.2] = ignore_index
    target = target.astype(target_dtype or KINDS[kind])
    if kind == "probs":
        preds = rng.random(shape).astype(np.float32)
    elif kind == "logits":
        preds = rng.normal(0.0, 2.0, shape).astype(np.float32)
    else:
        preds = rng.integers(0, 2, shape).astype(KINDS[kind])
    return preds, target


def run_family(task, family, args, batches, num_labels=None):
    """One family, functional and module, over ``batches`` in both packages."""
    name, cls, extra = family
    kw = {**args, **extra}
    if num_labels is not None:
        kw["num_labels"] = num_labels
    jfun, tfun = getattr(jax_fn, f"{task}_{name}"), getattr(torch_fn, f"{task}_{name}")
    jm = getattr(jax_cls, f"{task.capitalize()}{cls}")(**kw)
    tm = getattr(torch_cls, f"{task.capitalize()}{cls}")(**kw, **CPU)
    jstate, tstate = jm.init_state(), tm.init_state()
    for i, batch in enumerate(batches):
        jb, tb = both(batch)
        close(tfun(*tb, **kw), jfun(*jb, **kw))
        if i % 2:
            close(tm.forward(*tb), jm.forward(*jb))
        else:
            jm.update(*jb)
            tm.update(*tb)
        states_equal(tm, jm)
        jstate, tstate = jm.update_state(jstate, *jb), tm.update_state(tstate, *tb)
    close(tm.compute(), jm.compute())
    close(tm.compute_from(tstate), jm.compute_from(jstate))


@pytest.mark.parametrize("mda", ["global", "samplewise"])
@pytest.mark.parametrize("kind,ignore_index", CASES)
def test_binary_family_matches_jax(kind, ignore_index, mda):
    seed = sum(map(ord, f"{kind}{ignore_index}{mda}"))  # stable across processes
    rng = np.random.default_rng(seed)
    batches = [binary_batch(rng, SHAPES[mda], kind, ignore_index) for _ in range(2)]
    threshold = 0.3 if kind == "logits" else 0.5
    args = {"threshold": threshold, "multidim_average": mda, "ignore_index": ignore_index}
    for family in FAMILIES:
        run_family("binary", family, args, batches)


@pytest.mark.parametrize("normalize", [None, "none", "true", "pred", "all"])
@pytest.mark.parametrize("kind,ignore_index", [("probs", None), ("logits", -1), ("int64", 1), ("bool", 0)])
def test_binary_confusion_matrix_matches_jax(kind, ignore_index, normalize):
    rng = np.random.default_rng(sum(map(ord, f"{kind}{ignore_index}{normalize}")))
    batches = [binary_batch(rng, SHAPES["global"], kind, ignore_index) for _ in range(2)]
    run_family("binary", ("confusion_matrix", "ConfusionMatrix", {}),
               {"ignore_index": ignore_index, "normalize": normalize}, batches)


@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.7])
def test_logits_next_to_the_threshold_count_like_jax(threshold):
    """The float32 neighbours of logit(threshold), 2000 on each side: the sigmoid of
    the two stacks may differ in the last bits, which would flip a value lying
    within them of the threshold. The counts must still be bit-identical."""
    x0 = np.float32(np.log(threshold / (1 - threshold)))
    logits = (x0.view(np.int32) + np.arange(-2000, 2000, dtype=np.int32)).view(np.float32)
    logits[0] = 50.0  # one value outside [0, 1] at least: the sigmoid is taken
    target = np.random.default_rng(5).integers(0, 2, logits.shape).astype(np.int32)
    jb, tb = both((logits, target))
    close(torch_fn.binary_stat_scores(*tb, threshold=threshold),
          jax_fn.binary_stat_scores(*jb, threshold=threshold))


@pytest.mark.parametrize("mda", ["global", "samplewise"])
def test_values_outside_the_labels_count_like_jax_without_validation(mda):
    """With ``validate_args=False`` the masked products run on whatever values
    come: labels 2 and -3 count by the same arithmetic in both packages."""
    rng = np.random.default_rng(3)
    preds = rng.integers(-3, 3, SHAPES[mda]).astype(np.int32)
    target = rng.integers(-1, 3, SHAPES[mda]).astype(np.int32)
    jb, tb = both((preds, target))
    for ignore_index in (None, -1):
        kw = {"multidim_average": mda, "ignore_index": ignore_index, "validate_args": False}
        close(torch_fn.binary_stat_scores(*tb, **kw), jax_fn.binary_stat_scores(*jb, **kw))
        close(torch_fn.binary_accuracy(*tb, **kw), jax_fn.binary_accuracy(*jb, **kw))


def _bad_binary():
    f32, i32 = np.float32, np.int32
    return {
        "shape": (np.zeros(4, f32), np.zeros(5, i32), {}),
        "float_target": (np.zeros(4, f32), np.zeros(4, f32), {}),
        "target_values": (np.zeros(4, f32), np.array([0, 1, 2, 1], i32), {}),
        "target_ignored_elsewhere": (np.zeros(4, f32), np.array([0, 1, -1, 1], i32), {"ignore_index": 5}),
        "preds_values": (np.array([0, 3, 1, 1], i32), np.zeros(4, i32), {}),
        "samplewise_1d": (np.zeros(4, f32), np.zeros(4, i32), {"multidim_average": "samplewise"}),
        "empty": (np.zeros(0, f32), np.zeros(0, i32), {}),
        "threshold_int": (np.zeros(4, f32), np.zeros(4, i32), {"threshold": 1}),
        "threshold_range": (np.zeros(4, f32), np.zeros(4, i32), {"threshold": 1.5}),
        "multidim_average": (np.zeros(4, f32), np.zeros(4, i32), {"multidim_average": "all"}),
        "ignore_index_float": (np.zeros(4, f32), np.zeros(4, i32), {"ignore_index": 0.5}),
    }


@pytest.mark.parametrize("case", sorted(_bad_binary()))
def test_bad_binary_input_raises_the_jax_type(case):
    preds, target, kw = _bad_binary()[case]
    jb, tb = both((preds, target))
    for name in ("stat_scores", "accuracy", "precision"):
        with pytest.raises(Exception) as want:
            getattr(jax_fn, f"binary_{name}")(*jb, **kw)
        with pytest.raises(want.type):
            getattr(torch_fn, f"binary_{name}")(*tb, **kw)
    with pytest.raises(Exception) as want:
        jm = jax_cls.BinaryAccuracy(**kw)
        jm.update(*jb)
    with pytest.raises(want.type):
        tm = torch_cls.BinaryAccuracy(**kw, **CPU)
        tm.update(*tb)


def test_binary_confusion_matrix_argument_errors_match_jax():
    for kw in ({"normalize": "rows"}, {"threshold": 2.0}, {"ignore_index": "x"}):
        with pytest.raises(ValueError):
            jax_cls.BinaryConfusionMatrix(**kw)
        with pytest.raises(ValueError):
            torch_cls.BinaryConfusionMatrix(**kw, **CPU)
    with pytest.raises(ValueError):
        jax_cls.BinaryFBetaScore(beta=0)
    with pytest.raises(ValueError):
        torch_cls.BinaryFBetaScore(beta=0, **CPU)


# --------------------------------------------------------------------------- the task façades

FACADES = ["StatScores", "ConfusionMatrix", "Accuracy", "FBetaScore", "F1Score", "Precision", "Recall", "Specificity"]
FUNCTIONAL_FACADES = ["stat_scores", "confusion_matrix", "accuracy", "fbeta_score", "f1_score", "precision", "recall",
                      "specificity"]
_TASK_ARGS = {"binary": {}, "multiclass": {"num_classes": 4}, "multilabel": {"num_labels": 4}}


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel", "Binary", "MultiLabel"])
@pytest.mark.parametrize("facade", FACADES)
def test_facade_returns_the_jax_task_class(facade, task):
    kw = {**_TASK_ARGS[task.lower()], "threshold": 0.4, "ignore_index": 1}
    if facade not in ("ConfusionMatrix",):
        kw["multidim_average"] = "global"
    jm = getattr(jax_cls, facade)(task=task, **kw)
    tm = getattr(torch_cls, facade)(task=task, **kw, **CPU)
    assert type(tm).__name__ == type(jm).__name__
    assert isinstance(tm, getattr(torch_cls, type(jm).__name__))
    for attr in ("threshold", "ignore_index", "num_classes", "num_labels", "average", "top_k", "beta", "normalize"):
        assert getattr(tm, attr, None) == getattr(jm, attr, None), attr
    assert tm.device == torch.device("cpu")
    assert sorted(tm._defaults) == sorted(jm._defaults)


def _facade_batch(task):
    rng = np.random.default_rng(len(task))
    if task == "binary":
        return rng.random(12).astype(np.float32), rng.integers(0, 2, 12).astype(np.int32)
    if task == "multiclass":
        return rng.integers(0, 4, 12).astype(np.int32), rng.integers(0, 4, 12).astype(np.int32)
    return rng.random((12, 4)).astype(np.float32), rng.integers(0, 2, (12, 4)).astype(np.int32)


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("facade", FUNCTIONAL_FACADES)
def test_functional_facade_matches_jax(facade, task):
    jb, tb = both(_facade_batch(task))
    kw = dict(_TASK_ARGS[task])
    close(getattr(torch_fn, facade)(*tb, task=task, **kw), getattr(jax_fn, facade)(*jb, task=task, **kw))


@pytest.mark.parametrize("facade", FACADES)
def test_bad_task_raises_the_jax_type(facade):
    with pytest.raises(ValueError) as want:
        getattr(jax_cls, facade)(task="regression")
    with pytest.raises(ValueError, match="Invalid Classification") as got:
        getattr(torch_cls, facade)(task="regression", **CPU)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("facade", FUNCTIONAL_FACADES)
def test_bad_functional_task_raises_the_jax_type(facade):
    jb, tb = both(_facade_batch("binary"))
    with pytest.raises(ValueError) as want:
        getattr(jax_fn, facade)(*jb, task="ranking")
    with pytest.raises(ValueError) as got:
        getattr(torch_fn, facade)(*tb, task="ranking")
    assert str(got.value) == str(want.value)


def test_multiclass_facade_without_num_classes_fails_like_jax():
    with pytest.raises(AssertionError):
        jax_cls.Accuracy(task="multiclass")
    with pytest.raises(AssertionError):
        torch_cls.Accuracy(task="multiclass", **CPU)


# --------------------------------------------------------------------------- compute groups


def _binary_five(pkg, **kw):
    return {"acc": pkg.BinaryAccuracy(**kw), "f1": pkg.BinaryF1Score(**kw), "prec": pkg.BinaryPrecision(**kw),
            "rec": pkg.BinaryRecall(**kw), "spec": pkg.BinarySpecificity(**kw)}


def test_binary_collection_forms_the_jax_compute_groups():
    jcol, tcol = JaxCollection(_binary_five(jax_cls)), MetricCollection(_binary_five(torch_cls, **CPU))
    assert tcol.compute_groups == jcol.compute_groups
    rng = np.random.default_rng(11)
    for _ in range(2):
        jb, tb = both(binary_batch(rng, SHAPES["global"], "probs", None))
        jcol.update(*jb)
        tcol.update(*tb)
        assert tcol.compute_groups == jcol.compute_groups
    assert len(tcol.compute_groups) == 1
    got, want = tcol.compute(), jcol.compute()
    assert list(got) == list(want)
    for key in want:
        close(got[key], want[key])


@pytest.mark.parametrize("module", ["stat_scores", "confusion_matrix", "accuracy", "f_beta", "precision_recall",
                                    "specificity"])
def test_docstring_examples_run(module):
    import importlib

    for pkg in ("metrics_tpu_torch.classification", "metrics_tpu_torch.functional.classification"):
        result = doctest.testmod(importlib.import_module(f"{pkg}.{module}"), verbose=False)
        assert result.failed == 0, (pkg, module)
