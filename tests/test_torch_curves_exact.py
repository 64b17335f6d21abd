"""The port's curve metrics in exact mode (``thresholds=None``) against the
JAX package's, on the CPU.

The exact mode keeps the scores as list states and sorts them at compute
time. On the JAX side every eager op compiles anew for each data-dependent
length, so these cases use short batches and live apart from the binned ones
(``test_torch_curves.py``, whose data, helpers and tolerances they share):
list states equal in value, curves and scores within ``rtol=1e-5, atol=1e-6``.
The branch that keeps ignored rows as sentinel scores (taken where values
cannot be read, as under ``torch.compile``) is driven by making the value
checks impossible, and held to the same tolerance.
"""

import importlib

import pytest
import torch

from tests import test_torch_curves as base
from tests.test_torch_curves import (  # noqa: F401  (_one_torch_thread: the autouse fixture)
    BINARY,
    BINARY_IDS,
    C,
    FUNCTIONAL,
    MULTICLASS,
    MULTICLASS_IDS,
    MULTILABEL,
    MULTILABEL_IDS,
    _compare_classes,
    _one_torch_thread,
    binary_data,
    multiclass_data,
    multilabel_data,
)
import metrics_tpu.classification as jc
import metrics_tpu_torch.classification as tc

# the module, not the function of the same name that the package exports
prc = importlib.import_module("metrics_tpu_torch.functional.classification.precision_recall_curve")


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("jax_cls,port_cls,kw", BINARY, ids=BINARY_IDS)
def test_binary_exact_classes(jax_cls, port_cls, kw, ignore_index):
    batches = [binary_data(s, n=120, ignore=ignore_index is not None, exact=True, ties=True) for s in (3, 4)]
    _compare_classes(jax_cls, port_cls, batches, None, ignore_index=ignore_index, **kw)


@pytest.mark.parametrize("jax_cls,port_cls,kw", MULTICLASS, ids=MULTICLASS_IDS)
def test_multiclass_exact_classes(jax_cls, port_cls, kw):
    batches = [multiclass_data(s, n=80, ignore=True, exact=True) for s in (5, 6)]
    _compare_classes(jax_cls, port_cls, batches, None, num_classes=C, ignore_index=-1, **kw)


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("jax_cls,port_cls,kw", MULTILABEL, ids=MULTILABEL_IDS)
def test_multilabel_exact_classes(jax_cls, port_cls, kw, ignore_index):
    batches = [multilabel_data(s, n=80, ignore=ignore_index is not None, exact=True) for s in (7, 8)]
    _compare_classes(jax_cls, port_cls, batches, None, num_labels=C, ignore_index=ignore_index, **kw)


def test_multiclass_extra_dimension_exact():
    _compare_classes(jc.MulticlassAUROC, tc.MulticlassAUROC, [multiclass_data(9, n=30, extra=3)], None, num_classes=C)


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("name,kw", FUNCTIONAL, ids=[f[0] for f in FUNCTIONAL])
def test_task_functionals_exact(name, kw, task):
    base.test_task_functionals(name, kw, task, None)


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
def test_selection_functionals_exact(name, data, kw):
    base.test_selection_functionals(name, data, kw, None)


def test_merge_of_two_half_streams_exact():
    base.test_merge_of_two_half_streams_equals_the_single_stream(None)


def test_slice_three_updates_with_the_state_carried_over_from_jax_exact():
    base.test_slice_three_updates_with_the_state_carried_over_from_jax(None)



SENTINEL_CASES = (
    [(j, p, kw, binary_data, {}) for j, p, kw in BINARY]
    + [(j, p, kw, multiclass_data, {"num_classes": C}) for j, p, kw in MULTICLASS]
)
SENTINEL_IDS = [f"binary_{i}" for i in BINARY_IDS] + [f"multiclass_{i}" for i in MULTICLASS_IDS]


def _values_cannot_be_read(monkeypatch):
    """Make value checks impossible, as under ``torch.compile`` tracing; returns
    the dtypes of the tensors the port asked about."""
    seen = []

    def no_values(*tensors):
        seen.extend(t.dtype for t in tensors)
        return False

    monkeypatch.setattr(prc, "_value_check_possible", no_values)
    return seen


@pytest.mark.parametrize("jax_cls,port_cls,kw,data,task_kw", SENTINEL_CASES, ids=SENTINEL_IDS)
def test_exact_classes_keep_ignored_rows_as_sentinels_where_values_cannot_be_read(monkeypatch, jax_cls, port_cls, kw,
                                                                                 data, task_kw):
    """Under ``torch.compile`` tracing the exact mode keeps ignored rows at static
    shape with the sentinel score; what it computes equals the eager filtered
    path's and the JAX package's (the tolerance of the other exact cases).
    The multilabel classes keep a mask state instead and take no sentinel."""
    batches = [data(s, n=120 if data is binary_data else 80, ignore=True, exact=True) for s in (11, 12)]
    jm, filtered = _compare_classes(jax_cls, port_cls, batches, None, ignore_index=-1, **task_kw, **kw)
    _values_cannot_be_read(monkeypatch)
    traced = port_cls(thresholds=None, device="cpu", ignore_index=-1, **task_kw, **kw)
    for p, t in batches:
        traced.update(torch.from_numpy(p), torch.from_numpy(t))
    kept = sum(x.shape[0] for x in traced.preds)
    assert kept == sum(p.shape[0] for p, _ in batches) > sum(x.shape[0] for x in filtered.preds)
    assert bool((torch.cat(traced.preds) == prc._EXACT_IGNORE_SENTINEL).any())
    got = traced.compute()
    base._assert_close(got, filtered.compute(), f"{jax_cls.__name__} sentinel vs filtered")
    base._assert_close(got, jm.compute(), f"{jax_cls.__name__} sentinel vs JAX")


@pytest.mark.parametrize(
    "name,task,kw",
    [(name, task, kw) for task in ("binary", "multiclass") for name, kw in FUNCTIONAL]
    + [("auroc", "multilabel", {"average": "micro"}), ("average_precision", "multilabel", {"average": "micro"})],
)
def test_exact_functionals_with_sentinel_rows_equal_jax(monkeypatch, name, task, kw):
    """The task functionals in exact mode with ``ignore_index`` where values
    cannot be read: the ignore mask reaches the sentinel branch, and the
    result equals the JAX package's."""
    data = {"binary": binary_data, "multiclass": multiclass_data, "multilabel": multilabel_data}[task]
    p, t = data(11, n=80, ignore=True, exact=True)
    args = {"task": task, "thresholds": None, "ignore_index": -1,
            "num_classes": C if task == "multiclass" else None, "num_labels": C if task == "multilabel" else None}
    want = getattr(base.jf, name)(base.jnp.asarray(p), base.jnp.asarray(t), **args, **kw)
    seen = _values_cannot_be_read(monkeypatch)
    got = getattr(base.tf, name)(torch.from_numpy(p), torch.from_numpy(t), **args, **kw)
    assert torch.bool in seen  # the ignore mask was asked about: the sentinel branch ran
    base._assert_close(got, want, name)
