"""The port's Hamming distance and exact match (functionals, modules and
task façades) against the JAX package's, on the CPU.

The same seeded numpy batches go through both packages: float32, float64 and
float16 scores (probabilities and logits), int32 and int64 labels,
``ignore_index`` None, -1 and an in-range value, every ``average`` and both
``multidim_average`` modes, ``top_k`` 1 and 2. Every count state (tp/fp/tn/fn,
exact match's ``correct``, samplewise list entries) is int32 and
bit-identical; values within rtol 1e-6 (float32 divisions of int32 counts).
A ``MetricCollection`` of the flagship's accuracy and F1 with the Hamming
distance forms the JAX package's compute groups, and the multiclass global
update takes the pair count's stat-score route once an update.
"""

import numpy as np
import pytest
import torch

import metrics_tpu as jax_top
import metrics_tpu.classification as jax_cls
import metrics_tpu.functional.classification as jax_fn
import metrics_tpu_torch as torch_top
import metrics_tpu_torch.classification as torch_cls
import metrics_tpu_torch.functional.classification as torch_fn
from metrics_tpu_torch.kernels import confmat
from tests.test_torch_binary import CPU, both, close, states_equal

C = 5
N = 24
X = 3
SCORES = ("float32", "float64", "float16")
AVERAGES = ("micro", "macro", "weighted", "none", None)


def seed_of(*parts):
    return sum(map(ord, repr(parts)))


def _target(rng, shape, classes, ignore_index, dtype):
    target = rng.integers(0, classes, shape)
    if ignore_index is not None:
        target[rng.random(shape) < 0.2] = ignore_index
    return target.astype(dtype)


def binary_batch(rng, kind, ignore_index, mda):
    shape = (N,) if mda == "global" else (N // 4, X)
    target = _target(rng, shape, 2, ignore_index, np.int64 if kind == "int64" else np.int32)
    if kind in SCORES:
        preds = rng.random(shape).astype(kind)
    elif kind == "logits":
        preds = rng.normal(0.0, 2.0, shape).astype(np.float32)
    else:
        preds = rng.integers(0, 2, shape).astype(kind)
    return preds, target


def multiclass_batch(rng, kind, ignore_index, mda):
    shape = (N,) if mda == "global" else (N // 4, X)
    target = _target(rng, shape, C, ignore_index, np.int64 if kind != "int32" else np.int32)
    if kind in SCORES:  # scores well apart, so no two are equal in float16
        order = rng.permuted(np.tile(np.arange(C), (int(np.prod(shape)), 1)), axis=1)
        scores = (order + rng.random(order.shape) * 0.5).reshape(*shape, C)
        preds = np.moveaxis(scores, -1, 1).astype(kind)  # (N, C) or (N, C, X)
    else:
        preds = rng.integers(0, C, shape).astype(kind)
    return preds, target


def multilabel_batch(rng, kind, ignore_index, mda):
    shape = (N, C) if mda == "global" else (N // 4, C, X)
    target = _target(rng, shape, 2, ignore_index, np.int64 if kind == "int64" else np.int32)
    if kind in SCORES:
        preds = rng.random(shape).astype(kind)
    elif kind == "logits":
        preds = rng.normal(0.0, 2.0, shape).astype(np.float32)
    else:
        preds = rng.integers(0, 2, shape).astype(kind)
    return preds, target


BATCH = {"binary": binary_batch, "multiclass": multiclass_batch, "multilabel": multilabel_batch}
SIZE = {"binary": {}, "multiclass": {"num_classes": C}, "multilabel": {"num_labels": C}}
KINDS = {"binary": SCORES + ("logits", "int32", "int64"), "multiclass": SCORES + ("int32", "int64"),
         "multilabel": SCORES + ("logits", "int32", "int64")}
IGNORES = {"binary": (None, -1, 0), "multiclass": (None, -1, 2), "multilabel": (None, -1, 1)}


def run(fn_name, cls_name, kw, batches, fn_kw=None):
    """The functional on each batch, ``update`` / ``forward`` alternately, the
    states after every batch, then ``compute`` and ``compute_from``."""
    jfun, tfun = getattr(jax_fn, fn_name), getattr(torch_fn, fn_name)
    jm, tm = getattr(jax_cls, cls_name)(**kw), getattr(torch_cls, cls_name)(**kw, **CPU)
    jstate, tstate = jm.init_state(), tm.init_state()
    for i, batch in enumerate(batches):
        jb, tb = both(batch)
        close(tfun(*tb, **(fn_kw or kw)), jfun(*jb, **(fn_kw or kw)))
        if i % 2:
            close(tm.forward(*tb), jm.forward(*jb))
        else:
            jm.update(*jb)
            tm.update(*tb)
        states_equal(tm, jm)
        jstate, tstate = jm.update_state(jstate, *jb), tm.update_state(tstate, *tb)
    close(tm.compute(), jm.compute())
    close(tm.compute_from(tstate), jm.compute_from(jstate))
    return tm


HAMMING_CASES = [(task, kind, ignore, mda) for task in BATCH for kind in KINDS[task] for ignore in IGNORES[task]
                 for mda in ("global", "samplewise")]


@pytest.mark.parametrize("task,kind,ignore,mda", HAMMING_CASES, ids=["-".join(map(str, c)) for c in HAMMING_CASES])
def test_hamming_distance_matches_jax(task, kind, ignore, mda):
    rng = np.random.default_rng(seed_of(task, kind, ignore, mda))
    batches = [BATCH[task](rng, kind, ignore, mda) for _ in range(2)]
    base = {**SIZE[task], "multidim_average": mda, "ignore_index": ignore}
    if task == "binary":
        variants = [{"threshold": 0.3 if kind == "logits" else 0.5}]
    else:
        variants = [{"average": a} for a in AVERAGES]
        if task == "multiclass" and kind in SCORES:
            variants.append({"average": "macro", "top_k": 2})
        if task == "multilabel" and kind == "logits":
            variants = [{**v, "threshold": 0.3} for v in variants]
    for extra in variants:
        tm = run(f"{task}_hamming_distance", f"{task.capitalize()}HammingDistance", {**base, **extra}, batches)
        if mda == "global":
            assert all(getattr(tm, s).dtype == torch.int32 for s in ("tp", "fp", "tn", "fn"))


EXACT_CASES = [(task, kind, ignore, mda) for task in ("multiclass", "multilabel") for kind in KINDS[task]
               for ignore in IGNORES[task] for mda in ("global", "samplewise")]


@pytest.mark.parametrize("task,kind,ignore,mda", EXACT_CASES, ids=["-".join(map(str, c)) for c in EXACT_CASES])
def test_exact_match_matches_jax(task, kind, ignore, mda):
    rng = np.random.default_rng(seed_of("exact", task, kind, ignore, mda))
    batches = [BATCH[task](rng, kind, ignore, mda) for _ in range(3)]
    kw = {**SIZE[task], "multidim_average": mda, "ignore_index": ignore}
    if task == "multilabel" and kind == "logits":
        kw["threshold"] = 0.3
    tm = run(f"{task}_exact_match", f"{task.capitalize()}ExactMatch", kw, batches)
    if mda == "global":
        assert tm.correct.dtype == torch.int32 and tm.total.dtype == torch.float32
    else:
        assert isinstance(tm.correct, list) and all(c.dtype == torch.int32 for c in tm.correct)


def test_exact_match_counts_ignored_positions_as_correct():
    preds = np.array([[0, 1, 2], [0, 1, 2], [4, 4, 4]], np.int64)
    target = np.array([[0, 1, 2], [0, -1, 1], [-1, -1, -1]], np.int64)
    jb, tb = both((preds, target))
    for mda in ("global", "samplewise"):
        got = torch_fn.multiclass_exact_match(*tb, C, multidim_average=mda, ignore_index=-1)
        close(got, jax_fn.multiclass_exact_match(*jb, C, multidim_average=mda, ignore_index=-1))
    assert got.tolist() == [1.0, 0.0, 1.0]


FACADES = [
    ("hamming_distance", "HammingDistance", ("binary", "multiclass", "multilabel")),
    ("exact_match", "ExactMatch", ("multiclass", "multilabel")),
]


@pytest.mark.parametrize("fn_name,cls_name,tasks", FACADES, ids=[f[1] for f in FACADES])
def test_task_facades_match_jax(fn_name, cls_name, tasks):
    rng = np.random.default_rng(seed_of(cls_name))
    for task in tasks:
        for mda in ("global", "samplewise"):
            batch = BATCH[task](rng, "float32", -1, mda)
            jb, tb = both(batch)
            kw = {**SIZE[task], "ignore_index": -1, "multidim_average": mda}
            close(getattr(torch_fn, fn_name)(*tb, task=task, **kw), getattr(jax_fn, fn_name)(*jb, task=task, **kw))
            jm = getattr(jax_top, cls_name)(task=task, **kw)
            tm = getattr(torch_top, cls_name)(task=task, **kw, **CPU)
            assert type(tm).__name__ == type(jm).__name__
            jm.update(*jb)
            tm.update(*tb)
            states_equal(tm, jm)
            close(tm.compute(), jm.compute())


def test_multiclass_hamming_takes_the_stat_score_route_once_an_update():
    """Label and top-1 score predictions, global: one ``confmat.stat_scores``
    call an update (the kernel's stat-score route on the card)."""
    calls = []
    real = confmat.stat_scores
    m = torch_cls.MulticlassHammingDistance(C, **CPU)
    rng = np.random.default_rng(12)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(confmat, "stat_scores", lambda *a, **k: calls.append(a[2]) or real(*a, **k))
        for kind in ("int64", "float32"):
            preds, target = multiclass_batch(rng, kind, None, "global")
            m.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert calls == [C, C]


def _flagship(cls, extra):
    return {
        "accuracy": cls.MulticlassAccuracy(C, average="micro", **extra),
        "f1": cls.MulticlassF1Score(C, average="macro", **extra),
        "hamming": cls.MulticlassHammingDistance(C, **extra),
        "hamming_micro": cls.MulticlassHammingDistance(C, average="micro", **extra),
    }


@pytest.mark.parametrize("groups", [True, False])
def test_a_collection_with_accuracy_and_f1_forms_the_jax_compute_groups(groups):
    from metrics_tpu.collections import MetricCollection as JaxCollection

    from metrics_tpu_torch.collections import MetricCollection

    jc = JaxCollection(_flagship(jax_cls, {}), compute_groups=groups)
    tc = MetricCollection(_flagship(torch_cls, CPU), compute_groups=groups)
    assert tc.compute_groups == jc.compute_groups
    built = len(tc.compute_groups)  # groups seeded at construction: one stat-score call each in the first update
    rng = np.random.default_rng(21)
    calls = []
    real = confmat.stat_scores
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(confmat, "stat_scores", lambda *a, **k: calls.append(a[2]) or real(*a, **k))
        for _ in range(3):
            jb, tb = both(multiclass_batch(rng, "float32", None, "global"))
            jc.update(*jb)
            tc.update(*tb)
            assert tc.compute_groups == jc.compute_groups
            for name in _flagship(jax_cls, {}):
                states_equal(tc[name], jc[name])
    if groups:
        assert len(tc.compute_groups) == 1 and built > 1 and calls == [C] * (built + 2)
    jv, tv = jc.compute(), tc.compute()
    assert sorted(tv) == sorted(jv)
    for name in jv:
        close(tv[name], jv[name])


def _error(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


def _module(pkg, name, xs, *args, **kw):
    m = getattr(pkg, name)(*args, **kw, **({} if pkg is jax_cls else CPU))
    m.update(*xs)
    return m.compute()


ERRORS = {
    "hamming_average": lambda fn, cls, xs: fn.multiclass_hamming_distance(*xs, C, average="samples"),
    "hamming_mda": lambda fn, cls, xs: fn.multiclass_hamming_distance(*xs, C, multidim_average="all"),
    "hamming_task": lambda fn, cls, xs: fn.hamming_distance(*xs, task="ranking", num_classes=C),
    "hamming_labels_past_c": lambda fn, cls, xs: fn.multiclass_hamming_distance(*xs, 3),
    "exact_task": lambda fn, cls, xs: fn.exact_match(*xs, task="binary", num_classes=C),
    "exact_samplewise_1d": lambda fn, cls, xs: fn.multiclass_exact_match(*xs, C, multidim_average="samplewise"),
    "exact_num_classes": lambda fn, cls, xs: _module(cls, "MulticlassExactMatch", xs, 1),
    "exact_threshold": lambda fn, cls, xs: _module(cls, "MultilabelExactMatch", xs, C, threshold=2),
    "module_facade_task": lambda fn, cls, xs: cls.HammingDistance(task="ranking"),
    "module_exact_facade_task": lambda fn, cls, xs: cls.ExactMatch(task="regression"),
}


@pytest.mark.parametrize("what", sorted(ERRORS))
def test_bad_arguments_raise_the_jax_errors(what):
    rng = np.random.default_rng(3)
    jb, tb = both(multiclass_batch(rng, "int64", None, "global"))
    assert _error(lambda: ERRORS[what](torch_fn, torch_cls, tb)) == _error(lambda: ERRORS[what](jax_fn, jax_cls, jb))
