"""The port's confusion-matrix family (Jaccard index, Cohen's kappa, Matthews
correlation) against the JAX package's, on the CPU.

Each functional and module (binary, multiclass, multilabel and the task
façades) runs over the same numpy batches in both packages: float32, float64
and float16 scores, int32 and int64 labels, ``ignore_index`` None, -1 and an
in-range class, every ``average`` of the Jaccard index and every ``weights`` of
kappa. The confusion-matrix states are int32 and bit-identical to the JAX
package's. The outputs are float32 within ``RTOL``/``ATOL``: float32 sums of
int32 counts, which XLA and torch add in different orders (kappa's weighted
sums and the Matthews statistic's sums of products). Matthews's multiclass
statistic cancels (``s**2 - sum(pk * pk)``), so it is also held at C = 1000
on 10^6 labels, where its tolerance is ``MCC_WIDE_ATOL``. Bad ``weights``,
``average``, ``num_classes``, ``ignore_index`` and ``task`` raise the JAX
package's errors, and a collection of the three multiclass metrics with the
confusion matrix forms the JAX package's compute groups.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jax_top
import metrics_tpu.classification as jax_cls
import metrics_tpu.functional.classification as jax_fn
import metrics_tpu_torch as torch_top
import metrics_tpu_torch.classification as torch_cls
import metrics_tpu_torch.functional.classification as torch_fn

CPU = {"device": "cpu"}
RTOL = 1e-5  # float32 sums of the same counts in another order
ATOL = 1e-6
MCC_WIDE_ATOL = 1e-6  # Matthews at C = 1000, N = 10^6: |value| ~ 1e-3, its sums' last bits move
C = 5
N = 96
SCORE_DTYPES = (np.float32, np.float64, np.float16)
LABEL_DTYPES = (np.int32, np.int64)


def close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype), (got.dtype, want.dtype)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol, equal_nan=True)


def both(batch):
    return tuple(jnp.asarray(b) for b in batch), tuple(torch.from_numpy(np.ascontiguousarray(b)) for b in batch)


def _ignore(rng, target, ignore_index):
    if ignore_index is not None:
        target[rng.random(target.shape) < 0.15] = ignore_index
    return target


def binary_batch(rng, score_dtype, label_dtype, ignore_index, labels=False):
    target = _ignore(rng, rng.integers(0, 2, N), ignore_index).astype(label_dtype)
    preds = rng.integers(0, 2, N).astype(label_dtype) if labels else rng.random(N).astype(score_dtype)
    return preds, target


def multiclass_batch(rng, score_dtype, label_dtype, ignore_index, labels=False, classes=C):
    target = _ignore(rng, rng.integers(0, classes, N), ignore_index).astype(label_dtype)
    if labels:
        preds = rng.integers(0, classes, N).astype(label_dtype)
    else:  # logits well apart, so no two are equal in float16
        preds = (rng.permuted(np.tile(np.arange(classes), (N, 1)), axis=1) + rng.random((N, classes)) * 0.5)
        preds = preds.astype(score_dtype)
    return preds, target


def multilabel_batch(rng, score_dtype, label_dtype, ignore_index, labels=False):
    target = _ignore(rng, rng.integers(0, 2, (N, C)), ignore_index).astype(label_dtype)
    preds = rng.integers(0, 2, (N, C)).astype(label_dtype) if labels else rng.random((N, C)).astype(score_dtype)
    return preds, target


BATCH = {"binary": binary_batch, "multiclass": multiclass_batch, "multilabel": multilabel_batch}
SIZE = {"binary": {}, "multiclass": {"num_classes": C}, "multilabel": {"num_labels": C}}
# (functional, class, keyword variants) of each task
FAMILIES = {
    "binary": [
        ("binary_jaccard_index", "BinaryJaccardIndex", [{}]),
        ("binary_cohen_kappa", "BinaryCohenKappa", [{"weights": None}, {"weights": "linear"}, {"weights": "quadratic"}]),
        ("binary_matthews_corrcoef", "BinaryMatthewsCorrCoef", [{}]),
    ],
    "multiclass": [
        ("multiclass_jaccard_index", "MulticlassJaccardIndex",
         [{"average": a} for a in ("macro", "micro", "weighted", "none", None)]),
        ("multiclass_cohen_kappa", "MulticlassCohenKappa",
         [{"weights": None}, {"weights": "linear"}, {"weights": "quadratic"}]),
        ("multiclass_matthews_corrcoef", "MulticlassMatthewsCorrCoef", [{}]),
    ],
    "multilabel": [
        ("multilabel_jaccard_index", "MultilabelJaccardIndex",
         [{"average": a} for a in ("macro", "micro", "weighted", "none")]),
        ("multilabel_matthews_corrcoef", "MultilabelMatthewsCorrCoef", [{}]),
    ],
}
IGNORES = {"binary": (None, -1, 0), "multiclass": (None, -1, 2), "multilabel": (None, -1, 1)}
CASES = [
    (task, score, label, ignore, labels)
    for task in FAMILIES
    for score, label, labels in [(s, l, False) for s in SCORE_DTYPES for l in LABEL_DTYPES] + [(None, np.int64, True)]
    for ignore in IGNORES[task]
]


def _case_id(case):
    task, score, label, ignore, labels = case
    return f"{task}-{'labels' if labels else np.dtype(score).name}-{np.dtype(label).name}-ignore{ignore}"


def run_family(task, fn_name, cls_name, kw, batches):
    """One functional and one module over ``batches`` in both packages: the
    functional on each batch, ``update`` / ``forward`` alternately, the int32
    ``confmat`` state after every batch, then ``compute`` and the functional
    API's ``compute_from``."""
    jfun, tfun = getattr(jax_fn, fn_name), getattr(torch_fn, fn_name)
    jm, tm = getattr(jax_cls, cls_name)(**kw), getattr(torch_cls, cls_name)(**kw, **CPU)
    jstate, tstate = jm.init_state(), tm.init_state()
    for i, batch in enumerate(batches):
        jb, tb = both(batch)
        close(tfun(*tb, **kw), jfun(*jb, **kw))
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


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_family_matches_jax(case):
    task, score, label, ignore, labels = case
    rng = np.random.default_rng(sum(map(ord, _case_id(case))))
    batches = [BATCH[task](rng, score, label, ignore, labels=labels) for _ in range(3)]
    for fn_name, cls_name, variants in FAMILIES[task]:
        for extra in variants:
            kw = {**SIZE[task], "ignore_index": ignore, **extra}
            run_family(task, fn_name, cls_name, kw, batches)


FACADES = [
    ("jaccard_index", "JaccardIndex", ("binary", "multiclass", "multilabel"), {"average": "weighted"}),
    ("cohen_kappa", "CohenKappa", ("binary", "multiclass"), {"weights": "quadratic"}),
    ("matthews_corrcoef", "MatthewsCorrCoef", ("binary", "multiclass", "multilabel"), {}),
]


@pytest.mark.parametrize("fn_name,cls_name,tasks,extra", FACADES, ids=[f[1] for f in FACADES])
def test_task_facades_match_jax(fn_name, cls_name, tasks, extra):
    rng = np.random.default_rng(sum(map(ord, cls_name)))
    for task in tasks:
        batch = BATCH[task](rng, np.float32, np.int64, -1)
        jb, tb = both(batch)
        kw = {**SIZE[task], "ignore_index": -1, **(extra if task != "binary" or fn_name != "jaccard_index" else {})}
        close(getattr(torch_fn, fn_name)(*tb, task=task, **kw), getattr(jax_fn, fn_name)(*jb, task=task, **kw))
        jm, tm = getattr(jax_top, cls_name)(task=task, **kw), getattr(torch_top, cls_name)(task=task, **kw, **CPU)
        assert type(tm).__name__ == type(jm).__name__
        jm.update(*jb)
        tm.update(*tb)
        close(tm.confmat, jm.confmat)
        close(tm.compute(), jm.compute())


def test_ignore_index_drops_the_ignored_samples():
    """A value with ``ignore_index`` equals the value on the kept samples alone,
    in both packages."""
    rng = np.random.default_rng(7)
    preds, target = multiclass_batch(rng, np.float32, np.int64, -1, labels=True)
    keep = target != -1
    for fn_name, kw in [("multiclass_jaccard_index", {"average": "macro"}), ("multiclass_cohen_kappa", {}),
                        ("multiclass_matthews_corrcoef", {})]:
        tfun, jfun = getattr(torch_fn, fn_name), getattr(jax_fn, fn_name)
        got = tfun(torch.from_numpy(preds), torch.from_numpy(target), C, ignore_index=-1, **kw)
        kept = tfun(torch.from_numpy(preds[keep]), torch.from_numpy(target[keep]), C, **kw)
        assert torch.equal(got, kept)
        close(got, jfun(jnp.asarray(preds), jnp.asarray(target), C, ignore_index=-1, **kw))


def _error(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


ERRORS = {
    "kappa_weights": lambda fn, pkg, xs: fn.multiclass_cohen_kappa(*xs, C, weights="cubic"),
    "binary_kappa_weights": lambda fn, pkg, xs: fn.binary_cohen_kappa(xs[0] % 2, xs[1] % 2, weights="cubic"),
    "jaccard_average": lambda fn, pkg, xs: fn.multiclass_jaccard_index(*xs, C, average="samples"),
    "labels_past_num_classes": lambda fn, pkg, xs: fn.multiclass_matthews_corrcoef(*xs, 3),
    "ignore_index_type": lambda fn, pkg, xs: fn.binary_jaccard_index(xs[0] % 2, xs[1] % 2, ignore_index=0.5),
    "kappa_task": lambda fn, pkg, xs: fn.cohen_kappa(*xs, task="multilabel", num_classes=C),
    "jaccard_task": lambda fn, pkg, xs: fn.jaccard_index(*xs, task="ranking", num_classes=C),
    "mcc_task": lambda fn, pkg, xs: fn.matthews_corrcoef(*xs, task="regression", num_classes=C),
    "module_kappa_weights": lambda fn, pkg, xs: _module(pkg, "MulticlassCohenKappa", xs, weights="cubic"),
    "module_jaccard_average": lambda fn, pkg, xs: _module(pkg, "MulticlassJaccardIndex", xs, average="samples"),
    "module_facade_task": lambda fn, pkg, xs: getattr(pkg, "MatthewsCorrCoef")(task="ranking"),
}


def _module(pkg, name, xs, **kw):
    extra = CPU if pkg is torch_cls else {}
    m = getattr(pkg, name)(C, **kw, **extra)
    m.update(*xs)
    return m.compute()


@pytest.mark.parametrize("what", sorted(ERRORS))
def test_bad_arguments_raise_the_jax_errors(what):
    rng = np.random.default_rng(3)
    preds, target = multiclass_batch(rng, np.float32, np.int64, None, labels=True)
    jb, tb = both((preds, target))
    assert _error(lambda: ERRORS[what](torch_fn, torch_cls, tb)) == _error(lambda: ERRORS[what](jax_fn, jax_cls, jb))


@pytest.mark.parametrize("weights", [None, "linear", "quadratic"])
def test_kappa_of_a_constant_stream_and_an_empty_one(weights):
    """The 0/0 edges: one class only (kappa's denominator is 0) and every sample
    ignored (the matrix is all zeros): NaN where the JAX package gives NaN."""
    for preds, target in [(np.zeros(8, np.int64), np.zeros(8, np.int64)),
                          (np.zeros(8, np.int64), np.full(8, -1, np.int64))]:
        jb, tb = both((preds, target))
        close(torch_fn.multiclass_cohen_kappa(*tb, C, weights=weights, ignore_index=-1),
              jax_fn.multiclass_cohen_kappa(*jb, C, weights=weights, ignore_index=-1))


def test_matthews_zero_denominators_give_zero():
    """``denom == 0 -> 0.0`` in the binary, multiclass and multilabel branches."""
    for fn_name, kw, preds, target in [
        ("binary_matthews_corrcoef", {}, np.ones(8, np.int64), np.ones(8, np.int64)),
        ("multiclass_matthews_corrcoef", {"num_classes": C}, np.full(8, 2, np.int64), np.full(8, 2, np.int64)),
        ("multilabel_matthews_corrcoef", {"num_labels": C}, np.zeros((8, C), np.int64), np.zeros((8, C), np.int64)),
    ]:
        jb, tb = both((preds, target))
        got = getattr(torch_fn, fn_name)(*tb, **kw)
        close(got, getattr(jax_fn, fn_name)(*jb, **kw))
        assert got.item() == 0.0 and got.dtype == torch.float32


def test_matthews_at_a_thousand_classes_and_a_million_labels():
    """The cancelling statistic at C = 1000, N = 10^6: the table bit-identical,
    the value within ``MCC_WIDE_ATOL`` (and kappa and Jaccard within the
    family's tolerance) of the JAX package's."""
    rng = np.random.default_rng(1000)
    classes, n = 1000, 10**6
    target = rng.integers(0, classes, n).astype(np.int32)
    preds = np.where(rng.random(n) < 0.3, target, rng.integers(0, classes, n)).astype(np.int32)
    jb, tb = both((preds, target))
    close(torch_fn.multiclass_confusion_matrix(*tb, classes), jax_fn.multiclass_confusion_matrix(*jb, classes))
    close(torch_fn.multiclass_matthews_corrcoef(*tb, classes), jax_fn.multiclass_matthews_corrcoef(*jb, classes),
          rtol=0, atol=MCC_WIDE_ATOL)
    close(torch_fn.multiclass_cohen_kappa(*tb, classes, weights="quadratic"),
          jax_fn.multiclass_cohen_kappa(*jb, classes, weights="quadratic"))
    close(torch_fn.multiclass_jaccard_index(*tb, classes), jax_fn.multiclass_jaccard_index(*jb, classes))


def _family(cls, pkg_kw):
    return {
        "cm": cls.MulticlassConfusionMatrix(C, **pkg_kw),
        "jaccard": cls.MulticlassJaccardIndex(C, **pkg_kw),
        "kappa": cls.MulticlassCohenKappa(C, weights="linear", **pkg_kw),
        "mcc": cls.MulticlassMatthewsCorrCoef(C, **pkg_kw),
    }


@pytest.mark.parametrize("groups", [True, False])
def test_a_collection_forms_the_jax_compute_groups(groups):
    """The confusion matrix with the three metrics: the groups at construction
    and after the first update equal the JAX collection's, states stay int32
    and equal, and every value matches."""
    from metrics_tpu.collections import MetricCollection as JaxCollection

    from metrics_tpu_torch.collections import MetricCollection

    jc = JaxCollection(_family(jax_cls, {}), compute_groups=groups)
    tc = MetricCollection(_family(torch_cls, CPU), compute_groups=groups)
    assert tc.compute_groups == jc.compute_groups
    rng = np.random.default_rng(11)
    for _ in range(3):
        jb, tb = both(multiclass_batch(rng, np.float32, np.int64, None))
        jc.update(*jb)
        tc.update(*tb)
        assert tc.compute_groups == jc.compute_groups
        for name in ("cm", "jaccard", "kappa", "mcc"):
            close(tc[name].confmat, jc[name].confmat)
    if groups:
        assert list(tc.compute_groups.values()) == [["cm", "mcc", "jaccard", "kappa"]]
    jv, tv = jc.compute(), tc.compute()
    assert sorted(tv) == sorted(jv)
    for name in jv:
        close(tv[name], jv[name])
