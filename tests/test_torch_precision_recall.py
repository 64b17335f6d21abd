"""The port's multiclass precision, recall and specificity (functional and
module) against the JAX package's, on the CPU.

Every ``average`` ("micro", "macro", "weighted", "none"), ``top_k`` (1, 2),
``multidim_average`` ("global", "samplewise") and ``ignore_index`` (None, -1,
a class in range) runs over the same numpy batches (C = 5, N <= 48). States
are int32 and bit-identical; values agree within rtol=1e-6 (float32 divisions
and a float sum over classes, in other orders).
"""

import doctest

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.classification as jax_cls
from metrics_tpu.functional.classification.precision_recall import (
    multiclass_precision as jax_multiclass_precision,
    multiclass_recall as jax_multiclass_recall,
)
from metrics_tpu.functional.classification.specificity import multiclass_specificity as jax_multiclass_specificity
import metrics_tpu_torch.classification as torch_cls
from metrics_tpu_torch.classification import precision_recall, specificity
from metrics_tpu_torch.functional import multiclass_precision, multiclass_recall, multiclass_specificity

C = 5
NAMES = ("Precision", "Recall", "Specificity")
JAX_FN = {"Precision": jax_multiclass_precision, "Recall": jax_multiclass_recall,
          "Specificity": jax_multiclass_specificity}
TORCH_FN = {"Precision": multiclass_precision, "Recall": multiclass_recall, "Specificity": multiclass_specificity}


def _batches(seed, top_k, multidim_average, ignore_index, n_batches=2):
    """Probabilities when top_k > 1, labels otherwise; ignored targets when ignore_index is set."""
    rng = np.random.default_rng(seed)
    shape = (6, 8) if multidim_average == "samplewise" else (48,)
    out = []
    for _ in range(n_batches):
        target = rng.integers(0, C, shape)
        if ignore_index is not None:
            target[rng.random(shape) < 0.2] = ignore_index
        if top_k > 1:
            preds = rng.random((shape[0], C, *shape[1:])).astype(np.float32)
        else:
            preds = rng.integers(0, C, shape)
        out.append((preds, target))
    return out


def _close(got, want):
    want = np.asarray(want)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("ignore_index", [None, -1, 2], ids=["no_ignore", "ignore_-1", "ignore_2"])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("top_k", [1, 2], ids=["top1", "top2"])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
def test_precision_recall_specificity_match_jax(average, top_k, multidim_average, ignore_index):
    kw = dict(average=average, top_k=top_k, multidim_average=multidim_average, ignore_index=ignore_index)
    seed = sum(map(ord, f"{average}{top_k}{multidim_average}{ignore_index}"))  # stable across processes
    batches = _batches(seed, top_k, multidim_average, ignore_index)
    for name in NAMES:
        jm = getattr(jax_cls, f"Multiclass{name}")(C, **kw)
        tm = getattr(torch_cls, f"Multiclass{name}")(C, device="cpu", **kw)
        for p, t in batches:
            _close(TORCH_FN[name](torch.from_numpy(p), torch.from_numpy(t), C, **kw),
                   JAX_FN[name](jnp.asarray(p), jnp.asarray(t), C, **kw))
            jm.update(jnp.asarray(p), jnp.asarray(t))
            tm.update(torch.from_numpy(p), torch.from_numpy(t))
        for key in jm._defaults:
            got, want = getattr(tm, key), getattr(jm, key)
            if isinstance(want, list):
                assert len(got) == len(want)
                for g, w in zip(got, want):
                    _close(g, w)
            else:
                _close(got, want)
        _close(tm.compute(), jm.compute())


@pytest.mark.parametrize("name", NAMES)
def test_bad_arguments_raise_like_jax(name):
    for bad in (dict(average="median"), dict(top_k=0), dict(multidim_average="rowwise"), dict(ignore_index="x")):
        with pytest.raises(ValueError):
            getattr(jax_cls, f"Multiclass{name}")(C, **bad)
        with pytest.raises(ValueError):
            getattr(torch_cls, f"Multiclass{name}")(C, device="cpu", **bad)
    p, t = np.array([0, 1, 7]), np.array([0, 1, 2])  # a prediction beyond num_classes
    with pytest.raises(RuntimeError):
        JAX_FN[name](jnp.asarray(p), jnp.asarray(t), 3)
    with pytest.raises(RuntimeError):
        TORCH_FN[name](torch.from_numpy(p), torch.from_numpy(t), 3)


def test_plot_bounds_and_class_flags_match_jax():
    for name in NAMES:
        j, t = getattr(jax_cls, f"Multiclass{name}"), getattr(torch_cls, f"Multiclass{name}")
        for attr in ("is_differentiable", "higher_is_better", "full_state_update", "plot_lower_bound",
                     "plot_upper_bound"):
            assert getattr(t, attr) == getattr(j, attr), (name, attr)


@pytest.mark.parametrize("module", [precision_recall, specificity], ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_docstring_examples(module):
    result = doctest.testmod(module, verbose=False)
    assert result.failed == 0 and result.attempted > 0
