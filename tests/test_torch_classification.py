"""The port's three flagship metric classes (and their stat-scores base)
against the JAX package's, over several batches on the CPU.

The JAX side runs once in the registry's default mode (its bincount on the
CPU) and once under ``metrics_tpu.kernels.registry.forced("force")``, which
sends its pair count through the Pallas kernel in interpret mode, so the TPU
kernel itself is a reference. Integer states must match exactly (int32);
metric values within rtol=1e-6 (float32 division and a float sum over classes).
"""

import doctest

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.classification as jax_cls
from metrics_tpu import obs as jax_obs
from metrics_tpu.kernels import registry as jax_registry
from metrics_tpu.obs.instrument import KERNEL_DISPATCHES as JAX_KERNEL_DISPATCHES
import metrics_tpu_torch.classification as torch_cls
from metrics_tpu_torch.classification import accuracy, confusion_matrix, f_beta, stat_scores

NUM_CLASSES = 11

# Batch sizes no other test uses, so the JAX package's jitted updates trace
# afresh under each mode (a cached trace would keep its earlier lowering).
_SIZES = {"auto": (61, 67, 71), "force": (73, 79, 89)}


def _make(module, ignore_index, **extra):
    kw = dict(ignore_index=ignore_index, **extra)
    return {
        "accuracy": module.MulticlassAccuracy(NUM_CLASSES, average="micro", **kw),
        "f1": module.MulticlassF1Score(NUM_CLASSES, average="macro", **kw),
        "confmat": module.MulticlassConfusionMatrix(NUM_CLASSES, **kw),
        "fbeta_none": module.MulticlassFBetaScore(2.0, NUM_CLASSES, average="none", **kw),
        "stat_scores_weighted": module.MulticlassStatScores(NUM_CLASSES, average="weighted", **kw),
    }


def _close(got, want, exact):
    want = np.asarray(want)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    if exact:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def _states_equal(jax_metric, torch_metric):
    for name in jax_metric._defaults:
        _close(getattr(torch_metric, name), getattr(jax_metric, name), exact=True)


@pytest.mark.parametrize("ignore_index", [None, 3])
@pytest.mark.parametrize("jax_mode", ["auto", "force"])
def test_flagship_metrics_match_jax_over_batches(jax_mode, ignore_index):
    rng = np.random.default_rng(17 if ignore_index is None else 18)
    jm = _make(jax_cls, ignore_index)
    tm = _make(torch_cls, ignore_index, device="cpu")
    jax_states = {k: m.init_state() for k, m in jm.items()}
    torch_states = {k: m.init_state() for k, m in tm.items()}

    jax_obs.enable()
    try:
        JAX_KERNEL_DISPATCHES.clear()
        for i, n in enumerate(_SIZES[jax_mode]):
            logits = rng.standard_normal((n, NUM_CLASSES)).astype(np.float32)
            target = rng.integers(0, NUM_CLASSES, n)
            jl, jt = jnp.asarray(logits), jnp.asarray(target)
            tl, tt = torch.from_numpy(logits), torch.from_numpy(target)
            with jax_registry.forced(jax_mode):
                jax_out = {k: (m.forward(jl, jt) if i % 2 else m.update(jl, jt)) for k, m in jm.items()}
                jax_states = {k: m.update_state(jax_states[k], jl, jt) for k, m in jm.items()}
            torch_out = {k: (m.forward(tl, tt) if i % 2 else m.update(tl, tt)) for k, m in tm.items()}
            torch_states = {k: m.update_state(torch_states[k], tl, tt) for k, m in tm.items()}
            for k in jm:
                if i % 2:  # forward's batch value
                    _close(torch_out[k], jax_out[k], exact=k in ("confmat", "stat_scores_weighted"))
                _states_equal(jm[k], tm[k])
        pallas_used = JAX_KERNEL_DISPATCHES.value(kernel="pair_count_fused", impl="optimized", interpret="true")
    finally:
        jax_obs.disable()
    assert (pallas_used > 0) == (jax_mode == "force")

    for k in jm:
        exact = k in ("confmat", "stat_scores_weighted")
        _close(tm[k].compute(), jm[k].compute(), exact)
        _close(tm[k].compute_from(torch_states[k]), jm[k].compute_from(jax_states[k]), exact)
        for name, want in jax_states[k].items():
            _close(torch_states[k][name], want, exact=True)


@pytest.mark.parametrize("module", [accuracy, f_beta, stat_scores, confusion_matrix], ids=lambda m: m.__name__)
def test_docstring_examples_run(module):
    results = doctest.testmod(module, optionflags=doctest.NORMALIZE_WHITESPACE)
    assert results.attempted > 0 and results.failed == 0
