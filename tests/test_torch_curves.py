"""The port's curve metrics against the JAX package's, on the CPU.

PrecisionRecallCurve, ROC, AUROC, AveragePrecision, SpecificityAtSensitivity
and RecallAtFixedPrecision, binary, multiclass and multilabel, binned
(``thresholds`` given) and exact (``thresholds=None``), through the classes
(``device="cpu"``) and the functionals, on the same seeded numpy inputs.
The exact-mode cases are in ``test_torch_curves_exact.py``, on these helpers.

Tolerances:
- binned int32 states: bit-identical, dtype included;
- exact-mode list states: equal values;
- curve and score outputs: ``rtol=1e-5, atol=1e-6`` (float32 sums and means
  are taken in another order by the two stacks);
- logit inputs: ``sigmoid`` and ``softmax`` differ in the last bit between
  the stacks, which moves a score lying on a threshold to the next one. The
  logit tests allow a difference of 1 count per threshold cell, and then feed
  both sides the JAX-side probabilities, where the states must be
  bit-identical again.

Scores here are finite: on the JAX package's CPU backend a NaN score goes
through a bucketize route that counts it as above every threshold, where the
JAX kernel and the port count it as above none; the NaN test holds the port
to the JAX kernel's reference instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.classification as jc
import metrics_tpu.functional.classification as jf
import metrics_tpu_torch.classification as tc
import metrics_tpu_torch.functional.classification as tf
from metrics_tpu.kernels import binned_curve as jax_bc
from metrics_tpu_torch import obs
from metrics_tpu_torch.obs import instrument
from metrics_tpu_torch.utils.params_io import metric_state_from_jax

RTOL, ATOL = 1e-5, 1e-6
N, C = 240, 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one thread per test beside the suite's parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------- data


def _on_thresholds(rng, p, t=11):
    """Put a tenth of the scores exactly on ``jnp.linspace(0, 1, t)`` values."""
    grid = np.array(jnp.linspace(0, 1, t, dtype=jnp.float32))
    flat = p.reshape(-1)
    k = flat.size // 10
    flat[rng.choice(flat.size, k, replace=False)] = grid[rng.integers(0, t, k)]
    return p


def _ignored(rng, t, exact):
    """Mark ignored targets (-1): random ones, or for exact mode every 7th row, so
    that every column and batch keeps the same length (each new length costs
    the JAX side a compile of every op)."""
    if exact:
        t[::7] = -1
    else:
        t[rng.random(t.shape) < 0.15] = -1
    return t


def binary_data(seed, n=N, logits=False, ignore=False, exact=False, ties=None):
    """Scores with ties on thresholds unless ``exact`` (then only when ``ties``)."""
    rng = np.random.default_rng(seed)
    if logits:
        p = (rng.normal(size=n) * 3).astype(np.float32)
    else:
        p = rng.uniform(size=n).astype(np.float32)
        p = _on_thresholds(rng, p) if (not exact if ties is None else ties) else p
    t = rng.integers(0, 2, n).astype(np.int32)
    return p, _ignored(rng, t, exact) if ignore else t


def multiclass_data(seed, n=N, c=C, logits=False, ignore=False, extra=None, exact=False):
    rng = np.random.default_rng(seed)
    shape = (n, c) if extra is None else (n, c, extra)
    x = rng.normal(size=shape).astype(np.float32) * 2
    if logits:
        p = x
    else:
        e = np.exp(x - x.max(axis=1, keepdims=True))
        p = (e / e.sum(axis=1, keepdims=True)).astype(np.float32)  # rows sum to 1: no softmax on either side
    t = rng.integers(0, c, (n,) if extra is None else (n, extra)).astype(np.int32)
    return p, _ignored(rng, t, exact) if ignore else t


def multilabel_data(seed, n=N, c=C, logits=False, ignore=False, exact=False):
    """Scores with ties on thresholds, except in exact mode (distinct scores keep
    every column's curve the same length there)."""
    rng = np.random.default_rng(seed)
    if logits:
        p = (rng.normal(size=(n, c)) * 3).astype(np.float32)
    else:
        p = rng.uniform(size=(n, c)).astype(np.float32)
        p = p if exact else _on_thresholds(rng, p)
    t = rng.integers(0, 2, (n, c)).astype(np.int32)
    return p, _ignored(rng, t, exact) if ignore else t


def _thresholds_arg(kind):
    """The ``thresholds`` argument for each side: an int, a list, or an unsorted array with a duplicate."""
    if kind == "int":
        return 11, 11
    if kind == "list":
        vals = [0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0]
        return vals, list(vals)
    arr = np.array([0.7, 0.2, 0.2, 0.95, 0.05, 0.5], np.float32)
    return jnp.asarray(arr), torch.from_numpy(arr.copy())


# --------------------------------------------------------------------------- comparison


def _assert_close(got, want, what="value"):
    """Outputs: tensors, lists of tensors, or tuples of either."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{what}[{i}]")
        return
    assert isinstance(got, torch.Tensor), what
    w = np.asarray(want)
    g = got.detach().cpu().numpy()
    assert g.shape == w.shape, f"{what}: shape {g.shape} vs {w.shape}"
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, equal_nan=True, err_msg=what)


def _assert_state_equal(port_metric, jax_metric):
    for name in jax_metric._defaults:
        want, got = getattr(jax_metric, name), getattr(port_metric, name)
        if isinstance(want, list):
            assert len(got) == len(want), name
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        else:
            w = np.asarray(want)
            assert got.dtype == torch.int32 and w.dtype == np.int32, f"{name}: {got.dtype} vs {w.dtype}"
            np.testing.assert_array_equal(got.numpy(), w, err_msg=name)


def _compare_classes(jax_cls, port_cls, batches, thresholds=None, **kwargs):
    """Update both with the batches, hold states and computed values equal."""
    j_thr, p_thr = thresholds if isinstance(thresholds, tuple) else (thresholds, thresholds)
    jm = jax_cls(thresholds=j_thr, **kwargs)
    pm = port_cls(thresholds=p_thr, device="cpu", **kwargs)
    for p, t in batches:
        jm.update(jnp.asarray(p), jnp.asarray(t))
        pm.update(torch.from_numpy(p), torch.from_numpy(t))
    _assert_state_equal(pm, jm)
    _assert_close(pm.compute(), jm.compute(), jax_cls.__name__)
    return jm, pm


BINARY = [
    (jc.BinaryPrecisionRecallCurve, tc.BinaryPrecisionRecallCurve, {}),
    (jc.BinaryROC, tc.BinaryROC, {}),
    (jc.BinaryAUROC, tc.BinaryAUROC, {}),
    (jc.BinaryAUROC, tc.BinaryAUROC, {"max_fpr": 0.5}),
    (jc.BinaryAveragePrecision, tc.BinaryAveragePrecision, {}),
    (jc.BinarySpecificityAtSensitivity, tc.BinarySpecificityAtSensitivity, {"min_sensitivity": 0.6}),
    (jc.BinaryRecallAtFixedPrecision, tc.BinaryRecallAtFixedPrecision, {"min_precision": 0.5}),
]
BINARY_IDS = ["prc", "roc", "auroc", "auroc_max_fpr", "ap", "spec_at_sens", "recall_at_prec"]


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("kind", ["int", "list", "unsorted"])
@pytest.mark.parametrize("jax_cls,port_cls,kw", BINARY, ids=BINARY_IDS)
def test_binary_binned_classes(jax_cls, port_cls, kw, kind, ignore_index):
    batches = [binary_data(s, ignore=ignore_index is not None) for s in (1, 2)]
    _compare_classes(jax_cls, port_cls, batches, _thresholds_arg(kind), ignore_index=ignore_index, **kw)


MULTICLASS = [
    (jc.MulticlassPrecisionRecallCurve, tc.MulticlassPrecisionRecallCurve, {}),
    (jc.MulticlassROC, tc.MulticlassROC, {}),
    (jc.MulticlassAUROC, tc.MulticlassAUROC, {"average": "macro"}),
    (jc.MulticlassAUROC, tc.MulticlassAUROC, {"average": "weighted"}),
    (jc.MulticlassAUROC, tc.MulticlassAUROC, {"average": None}),
    (jc.MulticlassAveragePrecision, tc.MulticlassAveragePrecision, {"average": "macro"}),
    (jc.MulticlassAveragePrecision, tc.MulticlassAveragePrecision, {"average": "weighted"}),
    (jc.MulticlassAveragePrecision, tc.MulticlassAveragePrecision, {"average": "none"}),
    (jc.MulticlassSpecificityAtSensitivity, tc.MulticlassSpecificityAtSensitivity, {"min_sensitivity": 0.5}),
    (jc.MulticlassRecallAtFixedPrecision, tc.MulticlassRecallAtFixedPrecision, {"min_precision": 0.4}),
]
MULTICLASS_IDS = ["prc", "roc", "auroc_macro", "auroc_weighted", "auroc_none", "ap_macro", "ap_weighted", "ap_none",
                  "spec_at_sens", "recall_at_prec"]


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("jax_cls,port_cls,kw", MULTICLASS, ids=MULTICLASS_IDS)
def test_multiclass_binned_classes(jax_cls, port_cls, kw, ignore_index):
    batches = [multiclass_data(s, ignore=ignore_index is not None) for s in (5, 6)]
    _compare_classes(jax_cls, port_cls, batches, 9, num_classes=C, ignore_index=ignore_index, **kw)


MULTILABEL = [
    (jc.MultilabelPrecisionRecallCurve, tc.MultilabelPrecisionRecallCurve, {}),
    (jc.MultilabelROC, tc.MultilabelROC, {}),
    (jc.MultilabelAUROC, tc.MultilabelAUROC, {"average": "micro"}),
    (jc.MultilabelAUROC, tc.MultilabelAUROC, {"average": "macro"}),
    (jc.MultilabelAUROC, tc.MultilabelAUROC, {"average": "weighted"}),
    (jc.MultilabelAUROC, tc.MultilabelAUROC, {"average": None}),
    (jc.MultilabelAveragePrecision, tc.MultilabelAveragePrecision, {"average": "micro"}),
    (jc.MultilabelAveragePrecision, tc.MultilabelAveragePrecision, {"average": "macro"}),
    (jc.MultilabelAveragePrecision, tc.MultilabelAveragePrecision, {"average": "weighted"}),
    (jc.MultilabelAveragePrecision, tc.MultilabelAveragePrecision, {"average": "none"}),
    (jc.MultilabelSpecificityAtSensitivity, tc.MultilabelSpecificityAtSensitivity, {"min_sensitivity": 0.5}),
    (jc.MultilabelRecallAtFixedPrecision, tc.MultilabelRecallAtFixedPrecision, {"min_precision": 0.4}),
]
MULTILABEL_IDS = ["prc", "roc", "auroc_micro", "auroc_macro", "auroc_weighted", "auroc_none", "ap_micro", "ap_macro",
                  "ap_weighted", "ap_none", "spec_at_sens", "recall_at_prec"]


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("jax_cls,port_cls,kw", MULTILABEL, ids=MULTILABEL_IDS)
def test_multilabel_binned_classes(jax_cls, port_cls, kw, ignore_index):
    batches = [multilabel_data(s, ignore=ignore_index is not None) for s in (7, 8)]
    _compare_classes(jax_cls, port_cls, batches, 9, num_labels=C, ignore_index=ignore_index, **kw)


def test_multiclass_extra_dimension_is_flattened_like_jax():
    batches = [multiclass_data(9, n=30, extra=3)]
    _compare_classes(jc.MulticlassAUROC, tc.MulticlassAUROC, batches, 7, num_classes=C)


# --------------------------------------------------------------------------- logits


def _confmat_close_to_one_count(got, want):
    diff = np.abs(got.numpy().astype(np.int64) - np.asarray(want).astype(np.int64))
    assert got.dtype == torch.int32 and diff.max() <= 1, f"max count difference {diff.max()}"


@pytest.mark.parametrize(
    "task,data,jax_cls,port_cls,kw,probs",
    [
        ("binary", binary_data, jc.BinaryAUROC, tc.BinaryAUROC, {}, jax.nn.sigmoid),
        ("multiclass", multiclass_data, jc.MulticlassAUROC, tc.MulticlassAUROC, {"num_classes": C},
         lambda x: jax.nn.softmax(x, axis=1)),
        ("multilabel", multilabel_data, jc.MultilabelAUROC, tc.MultilabelAUROC, {"num_labels": C}, jax.nn.sigmoid),
    ],
)
def test_logit_inputs(task, data, jax_cls, port_cls, kw, probs):
    """Logits: within one count per threshold cell of JAX (the last bit of
    sigmoid/softmax differs); the JAX-side probabilities: bit-identical."""
    p, t = data(10, logits=True)
    jm = jax_cls(thresholds=101, **kw)
    pm = port_cls(thresholds=101, device="cpu", **kw)
    jm.update(jnp.asarray(p), jnp.asarray(t))
    pm.update(torch.from_numpy(p), torch.from_numpy(t))
    _confmat_close_to_one_count(pm.confmat, jm.confmat)
    np.testing.assert_allclose(pm.compute().numpy(), np.asarray(jm.compute()), rtol=1e-3, atol=1e-3)

    jax_probs = np.array(probs(jnp.asarray(p)))
    _compare_classes(jax_cls, port_cls, [(jax_probs, t)], 101, **kw)


# --------------------------------------------------------------------------- functionals


FUNCTIONAL = [
    ("precision_recall_curve", {}),
    ("roc", {}),
    ("auroc", {}),
    ("average_precision", {}),
]


@pytest.mark.parametrize("thresholds", [11])
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("name,kw", FUNCTIONAL, ids=[f[0] for f in FUNCTIONAL])
def test_task_functionals(name, kw, task, thresholds):
    data = {"binary": binary_data, "multiclass": multiclass_data, "multilabel": multilabel_data}[task]
    p, t = data(11, n=N if thresholds else 80, ignore=True, exact=thresholds is None)
    args = {"task": task, "thresholds": thresholds, "ignore_index": -1,
            "num_classes": C if task == "multiclass" else None, "num_labels": C if task == "multilabel" else None}
    want = getattr(jf, name)(jnp.asarray(p), jnp.asarray(t), **args, **kw)
    got = getattr(tf, name)(torch.from_numpy(p), torch.from_numpy(t), **args, **kw)
    _assert_close(got, want, name)


@pytest.mark.parametrize("thresholds", [11])
@pytest.mark.parametrize(
    "name,data,kw",
    [
        ("binary_specificity_at_sensitivity", binary_data, {"min_sensitivity": 0.6}),
        ("multiclass_specificity_at_sensitivity", multiclass_data, {"num_classes": C, "min_sensitivity": 0.6}),
        ("multilabel_specificity_at_sensitivity", multilabel_data, {"num_labels": C, "min_sensitivity": 0.6}),
        ("binary_recall_at_fixed_precision", binary_data, {"min_precision": 0.5}),
        ("multiclass_recall_at_fixed_precision", multiclass_data, {"num_classes": C, "min_precision": 0.5}),
        ("multilabel_recall_at_fixed_precision", multilabel_data, {"num_labels": C, "min_precision": 0.5}),
        ("binary_auroc", binary_data, {"max_fpr": 0.3}),
    ],
)
def test_selection_functionals(name, data, kw, thresholds):
    p, t = data(12, n=N if thresholds else 80, exact=thresholds is None)
    want = getattr(jf, name)(jnp.asarray(p), jnp.asarray(t), thresholds=thresholds, **kw)
    got = getattr(tf, name)(torch.from_numpy(p), torch.from_numpy(t), thresholds=thresholds, **kw)
    _assert_close(got, want, name)


def test_binned_update_is_one_registry_dispatch_per_update():
    obs.enable()
    try:
        instrument.KERNEL_DISPATCHES.clear()
        for port_cls, kw, data in ((tc.BinaryAUROC, {}, binary_data), (tc.MulticlassAUROC, {"num_classes": C}, multiclass_data),
                                   (tc.MultilabelAveragePrecision, {"num_labels": C}, multilabel_data)):
            m = port_cls(thresholds=5, device="cpu", **kw)
            for seed in (1, 2):
                p, t = data(seed)
                m.update(torch.from_numpy(p), torch.from_numpy(t))
        assert instrument.KERNEL_DISPATCHES.value(kernel="binned_curve_counts", impl="reference") == 6
    finally:
        obs.disable()


# --------------------------------------------------------------------------- NaN scores


def test_nan_scores_follow_the_jax_kernel_not_its_cpu_bucketize_route():
    """The smallest input: preds [0.1, nan, 0.7, 0.5], target [1, 1, 0, 1], thresholds
    linspace(0, 1, 5). The JAX CPU route counts the NaN as above every threshold
    (tp [3, 2, 2, 1, 1]); its kernel's reference, and the port, as above none
    (tp [2, 1, 1, 0, 0])."""
    p = np.array([0.1, np.nan, 0.7, 0.5], np.float32)
    t = np.array([1, 1, 0, 1], np.int32)
    thr = jnp.linspace(0, 1, 5, dtype=jnp.float32)
    w = jnp.ones(4, jnp.float32)
    tp, fp = jax_bc.reference_counts(jnp.asarray(p), jnp.asarray(t, jnp.float32), w, thr)
    pallas_tp, pallas_fp = jax_bc.pallas_counts(jnp.asarray(p), jnp.asarray(t, jnp.float32), w, thr, interpret=True)
    np.testing.assert_array_equal(np.asarray(tp), np.asarray(pallas_tp))
    pos, neg = 3.0, 1.0
    want = np.stack([np.stack([neg - np.asarray(fp), np.asarray(fp)], -1),
                     np.stack([pos - np.asarray(tp), np.asarray(tp)], -1)], -2).astype(np.int32)
    m = tc.BinaryPrecisionRecallCurve(thresholds=5, device="cpu")
    m.update(torch.from_numpy(p), torch.from_numpy(t))
    np.testing.assert_array_equal(m.confmat.numpy(), want)
    np.testing.assert_array_equal(m.confmat.numpy()[:, 1, 1], [2, 1, 1, 0, 0])
    jm = jc.BinaryPrecisionRecallCurve(thresholds=5)
    jm.update(jnp.asarray(p), jnp.asarray(t))
    np.testing.assert_array_equal(np.asarray(jm.confmat)[:, 1, 1], [3, 2, 2, 1, 1])  # the JAX CPU route's difference


# --------------------------------------------------------------------------- metric API


def test_facades_build_the_task_classes():
    for facade, kw, want in (
        (tc.PrecisionRecallCurve, {"task": "binary"}, tc.BinaryPrecisionRecallCurve),
        (tc.ROC, {"task": "multiclass", "num_classes": 3}, tc.MulticlassROC),
        (tc.AUROC, {"task": "multilabel", "num_labels": 3, "average": "micro"}, tc.MultilabelAUROC),
        (tc.AUROC, {"task": "binary", "max_fpr": 0.5}, tc.BinaryAUROC),
        (tc.AveragePrecision, {"task": "multiclass", "num_classes": 3}, tc.MulticlassAveragePrecision),
        (tc.SpecificityAtSensitivity, {"task": "binary", "min_sensitivity": 0.5}, tc.BinarySpecificityAtSensitivity),
        (tc.RecallAtFixedPrecision, {"task": "multilabel", "num_labels": 2, "min_precision": 0.5},
         tc.MultilabelRecallAtFixedPrecision),
    ):
        m = facade(thresholds=5, device="cpu", **kw)
        assert type(m) is want
        assert m.confmat.dtype == torch.int32 and m.confmat.device.type == "cpu"
    with pytest.raises(ValueError):
        tc.AUROC(task="regression", device="cpu")
    with pytest.raises(ValueError):
        jc.AUROC(task="regression")


def test_a_curve_metric_without_device_runs_on_the_gpu_or_raises():
    if torch.cuda.is_available():
        assert tc.BinaryAUROC(thresholds=5).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tc.BinaryAUROC(thresholds=5)


BAD_INPUTS = [
    ("binary_auroc", (np.zeros(4, np.float32), np.zeros(4, np.int32)), {"thresholds": 1}),
    ("binary_auroc", (np.zeros(4, np.float32), np.zeros(4, np.int32)), {"thresholds": [0.5, 1.5]}),
    ("binary_auroc", (np.zeros(4, np.float32), np.zeros(4, np.int32)), {"thresholds": 2.5}),
    ("binary_auroc", (np.zeros(4, np.float32), np.zeros(4, np.int32)), {"ignore_index": 0.5}),
    ("binary_auroc", (np.zeros(4, np.float32), np.zeros(4, np.int32)), {"max_fpr": 2.0}),
    ("binary_auroc", (np.zeros(4, np.int32), np.zeros(4, np.int32)), {}),
    ("binary_auroc", (np.zeros(4, np.float32), np.zeros(4, np.float32)), {}),
    ("binary_auroc", (np.zeros(4, np.float32), np.array([0, 1, 2, 1], np.int32)), {}),
    ("binary_auroc", (np.zeros(4, np.float32), np.zeros(5, np.int32)), {}),
    ("multiclass_auroc", (np.zeros((4, 3), np.float32), np.zeros(4, np.int32)), {"num_classes": 1}),
    ("multiclass_auroc", (np.zeros((4, 3), np.float32), np.zeros(4, np.int32)), {"num_classes": 3, "average": "micro"}),
    ("multiclass_auroc", (np.zeros((4, 3), np.float32), np.zeros(4, np.int32)), {"num_classes": 4}),
    ("multiclass_auroc", (np.zeros((4, 3), np.float32), np.array([0, 1, 5, 1], np.int32)), {"num_classes": 3}),
    ("multiclass_auroc", (np.zeros((4, 3), np.float32), np.zeros((4, 3), np.int32)), {"num_classes": 3}),
    ("multilabel_auroc", (np.zeros((4, 3), np.float32), np.zeros((4, 2), np.int32)), {"num_labels": 3}),
    ("multilabel_auroc", (np.zeros((4, 3), np.float32), np.zeros((4, 3), np.int32)), {"num_labels": 2}),
    ("multilabel_auroc", (np.zeros((4, 3), np.float32), np.zeros((4, 3), np.int32)), {"num_labels": 3, "average": "x"}),
    ("binary_specificity_at_sensitivity", (np.zeros(4, np.float32), np.zeros(4, np.int32)), {"min_sensitivity": 2.0}),
    ("binary_recall_at_fixed_precision", (np.zeros(4, np.float32), np.zeros(4, np.int32)), {"min_precision": 1}),
]


@pytest.mark.parametrize("name,arrays,kw", BAD_INPUTS)
def test_bad_input_raises_the_same_error(name, arrays, kw):
    with pytest.raises(Exception) as want:
        getattr(jf, name)(*[jnp.asarray(a) for a in arrays], **kw)
    with pytest.raises(want.type) as got:
        getattr(tf, name)(*[torch.from_numpy(a) for a in arrays], **kw)
    assert str(got.value)[:30] == str(want.value)[:30]  # the rest names dtypes and shapes in each stack's spelling


_SCORES2 = np.array([0.2, 0.4], np.float32)
_SCORES3 = np.array([0.2, 0.4, 0.9], np.float32)
_PROBS3 = np.array([[0.2, 0.3, 0.5], [0.6, 0.3, 0.1], [0.1, 0.1, 0.8]], np.float32)
DEGENERATE_INPUTS = [
    # exact mode with no row kept: JAX's gather of the last index raises TypeError (an
    # accident of its code that the port copies)
    ("binary_roc", (_SCORES2, np.array([-1, -1], np.int32)), {"ignore_index": -1}, TypeError),
    ("binary_precision_recall_curve", (_SCORES2, np.array([-1, -1], np.int32)), {"ignore_index": -1}, TypeError),
    ("binary_auroc", (np.zeros(0, np.float32), np.zeros(0, np.int32)), {}, TypeError),
    ("binary_average_precision", (np.zeros(0, np.float32), np.zeros(0, np.int32)), {}, TypeError),
    # a 2-D thresholds tensor: ValueError from JAX's searchsorted, from the port's argument check
    ("binary_precision_recall_curve", (_SCORES3, np.array([1, 0, 1], np.int32)),
     {"thresholds": np.array([[0.1, 0.5]], np.float32)}, ValueError),
    ("binary_roc", (_SCORES3, np.array([1, 0, 1], np.int32)),
     {"thresholds": np.array([[0.1], [0.5]], np.float32), "validate_args": False}, ValueError),
    ("multiclass_precision_recall_curve", (_PROBS3, np.array([0, 1, 2], np.int32)),
     {"num_classes": 3, "thresholds": np.array([[0.1, 0.5]], np.float32)}, ValueError),
]


@pytest.mark.parametrize("name,arrays,kw,error", DEGENERATE_INPUTS)
def test_degenerate_input_raises_the_jax_type(name, arrays, kw, error):
    """Inputs on which the port once raised another type than the JAX package."""
    jax_kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    port_kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    with pytest.raises(Exception) as want:
        getattr(jf, name)(*[jnp.asarray(a) for a in arrays], **jax_kw)
    assert want.type is error
    with pytest.raises(error):
        getattr(tf, name)(*[torch.from_numpy(a) for a in arrays], **port_kw)


def test_exact_class_with_no_row_kept_raises_the_jax_type_at_compute():
    preds, target = _SCORES2, np.array([-1, -1], np.int32)
    jm = jc.BinaryROC(thresholds=None, ignore_index=-1)
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    with pytest.raises(TypeError):
        jm.compute()
    tm = tc.BinaryROC(thresholds=None, ignore_index=-1, device="cpu")
    tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    with pytest.raises(TypeError):
        tm.compute()


@pytest.mark.parametrize("thresholds", [11])
def test_merge_of_two_half_streams_equals_the_single_stream(thresholds):
    batches = [binary_data(s, n=N if thresholds else 80, exact=thresholds is None) for s in (20, 21, 22, 23)]
    pm = tc.BinaryAveragePrecision(thresholds=thresholds, device="cpu")
    jm = jc.BinaryAveragePrecision(thresholds=thresholds)

    def fold(m, arr, bs):
        state = m.init_state()
        for p, t in bs:
            state = m.update_state(state, arr(p), arr(t))
        return state

    torch_arr = torch.from_numpy
    merged = pm.merge_states(fold(pm, torch_arr, batches[:2]), fold(pm, torch_arr, batches[2:]))
    single = fold(pm, torch_arr, batches)
    jax_single = fold(jm, jnp.asarray, batches)
    if thresholds is None:
        for key in ("preds", "target"):
            assert len(merged[key]) == len(single[key]) == 4
            assert torch.equal(torch.cat(merged[key]), torch.cat(single[key]))
    else:
        assert torch.equal(merged["confmat"], single["confmat"]) and merged["confmat"].dtype == torch.int32
        np.testing.assert_array_equal(single["confmat"].numpy(), np.asarray(jax_single["confmat"]))
    assert int(merged["_update_count"]) == 4
    _assert_close(pm.compute_from(merged), jm.compute_from(jax_single))


def test_state_dict_is_strict_and_takes_a_jax_state():
    jm = jc.MultilabelAveragePrecision(num_labels=C, thresholds=9)
    p, t = multilabel_data(30)
    jm.update(jnp.asarray(p), jnp.asarray(t))
    pm = tc.MultilabelAveragePrecision(num_labels=C, thresholds=9, device="cpu")
    assert pm.state_dict() == {} and jm.state_dict() == {}  # no persistent state, as in the JAX package
    pm.load_state_dict({"confmat": np.asarray(jm.confmat)})
    assert pm.confmat.dtype == torch.int32
    _assert_close(pm.compute(), jm.compute())
    with pytest.raises(KeyError, match="Unexpected"):
        pm.load_state_dict({"confmat": np.asarray(jm.confmat), "stale": np.zeros(1)})


def test_forward_and_reset():
    pm = tc.BinaryROC(thresholds=7, device="cpu")
    jm = jc.BinaryROC(thresholds=7)
    for seed in (40, 41):
        p, t = binary_data(seed)
        _assert_close(pm(torch.from_numpy(p), torch.from_numpy(t)), jm(jnp.asarray(p), jnp.asarray(t)), "forward")
    _assert_state_equal(pm, jm)
    pm.reset()
    assert not pm.confmat.any() and pm.update_count == 0


# --------------------------------------------------------------------------- the slice


@pytest.mark.parametrize("thresholds", [200])
def test_slice_three_updates_with_the_state_carried_over_from_jax(thresholds):
    """The four binary classes: one update in JAX, the state carried into the
    port by ``metric_state_from_jax``, two more updates in the port; states and
    values held against the JAX classes after all three."""
    batches = [binary_data(s, n=500 if thresholds else 120, ignore=True, exact=thresholds is None) for s in (50, 51, 52)]
    pairs = [
        (jc.BinaryPrecisionRecallCurve(thresholds=thresholds, ignore_index=-1),
         tc.BinaryPrecisionRecallCurve(thresholds=thresholds, ignore_index=-1, device="cpu")),
        (jc.BinaryROC(thresholds=thresholds, ignore_index=-1), tc.BinaryROC(thresholds=thresholds, ignore_index=-1, device="cpu")),
        (jc.BinaryAUROC(thresholds=thresholds, ignore_index=-1), tc.BinaryAUROC(thresholds=thresholds, ignore_index=-1, device="cpu")),
        (jc.BinaryAveragePrecision(thresholds=thresholds, ignore_index=-1),
         tc.BinaryAveragePrecision(thresholds=thresholds, ignore_index=-1, device="cpu")),
    ]
    for jm, pm in pairs:
        j_state = jm.init_state()
        j_state = jm.update_state(j_state, *map(jnp.asarray, batches[0]))
        carried = metric_state_from_jax(
            {k: [np.asarray(x) for x in v] if isinstance(v, list) else np.asarray(v) for k, v in j_state.items()},
            device="cpu")
        for p, t in batches[1:]:
            j_state = jm.update_state(j_state, jnp.asarray(p), jnp.asarray(t))
            carried = pm.update_state(carried, torch.from_numpy(p), torch.from_numpy(t))
        assert carried["_update_count"].dtype == torch.int32 and int(carried["_update_count"]) == 3
        if thresholds is None:
            for key in ("preds", "target"):
                np.testing.assert_array_equal(torch.cat(carried[key]).numpy(), np.concatenate([np.asarray(x) for x in j_state[key]]))
        else:
            assert carried["confmat"].dtype == torch.int32
            np.testing.assert_array_equal(carried["confmat"].numpy(), np.asarray(j_state["confmat"]))
        _assert_close(pm.compute_from(carried), jm.compute_from(j_state), type(pm).__name__)


# --------------------------------------------------------------------------- helpers of the slice


@pytest.mark.parametrize("reorder", [False, True])
def test_auc_matches_jax(reorder):
    from metrics_tpu.utils.compute import auc as jax_auc
    from metrics_tpu_torch.utils.compute import auc

    rng = np.random.default_rng(60)
    for x in (np.sort(rng.uniform(size=50)), np.sort(rng.uniform(size=50))[::-1], rng.uniform(size=50)):
        x = x.astype(np.float32).copy()
        y = rng.uniform(size=50).astype(np.float32)
        want = jax_auc(jnp.asarray(x), jnp.asarray(y), reorder=reorder)
        _assert_close(auc(torch.from_numpy(x), torch.from_numpy(y), reorder=reorder), want, "auc")
    with pytest.raises(ValueError):
        auc(torch.zeros(3), torch.zeros(4))


def test_bincount_keeps_the_jax_semantics():
    from metrics_tpu.utils.data import _bincount as jax_bincount
    from metrics_tpu_torch.utils.data import _bincount

    x = np.array([-3, 0, 1, 1, 4, 7, 2], np.int32)  # negatives count in bin 0, values >= length drop
    want = np.asarray(jax_bincount(jnp.asarray(x), minlength=5))
    got = _bincount(torch.from_numpy(x), minlength=5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
