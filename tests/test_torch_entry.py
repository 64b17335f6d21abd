"""The whole slice at a small size: the port's fused train step against the
JAX package's, on the CPU.

The JAX step is ``bench.py``'s metric step (forward, ``value_and_grad``, SGD
``p - 0.01 * g``, argmax, three ``update_state`` calls) at batch 64, hidden
32, 8 classes, 2 layers. Parameters made with numpy go to JAX as they are and
to the port through ``params_from_jax``. Tolerances: loss and updated
parameters within atol=1e-5 (float32 matmuls summed in another order); metric
states bit-identical (int32); metric values within rtol=1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.classification.accuracy import MulticlassAccuracy
from metrics_tpu.classification.confusion_matrix import MulticlassConfusionMatrix
from metrics_tpu.classification.f_beta import MulticlassF1Score
from metrics_tpu_torch import entry as port
from metrics_tpu_torch.utils.params_io import metric_state_from_jax, params_from_jax

BATCH, HIDDEN, CLASSES, LAYERS = 64, 32, 8, 2
STEPS = 3


def _jax_metrics():
    return {
        "accuracy": MulticlassAccuracy(CLASSES, average="micro", validate_args=False),
        "f1": MulticlassF1Score(CLASSES, average="macro", validate_args=False),
        "confmat": MulticlassConfusionMatrix(CLASSES, validate_args=False),
    }


def _jax_forward(params, x, y):
    h = x
    for w in params["ws"]:
        h = jnp.tanh(h @ w)
    logits = h @ params["head"]
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1)), logits


def _jax_step(metrics, params, states, x, y):
    (loss, logits), grads = jax.value_and_grad(_jax_forward, has_aux=True)(params, x, y)
    params = jax.tree_util.tree_map(lambda p, g: p - 0.01 * g, params, grads)
    preds = jnp.argmax(logits, axis=-1)
    states = {name: m.update_state(states[name], preds, y) for name, m in metrics.items()}
    return loss, params, states, logits


def _numpy_inputs(seed=0):
    rng = np.random.default_rng(seed)
    # weights large enough that logits are O(1): argmax ties stay far away
    params = {
        "ws": [(rng.standard_normal((HIDDEN, HIDDEN)) * 0.3).astype(np.float32) for _ in range(LAYERS)],
        "head": (rng.standard_normal((HIDDEN, CLASSES)) * 0.3).astype(np.float32),
    }
    x = rng.standard_normal((BATCH, HIDDEN)).astype(np.float32)
    y = rng.integers(0, CLASSES, BATCH)
    return params, x, y


def _assert_argmax_is_robust(logits):
    top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-4, "test data too close to an argmax tie"


def _assert_params_close(torch_params, jax_params):
    for got, want in zip([*torch_params["ws"], torch_params["head"]], [*jax_params["ws"], jax_params["head"]]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _assert_states_equal(torch_states, jax_states):
    for name, state in jax_states.items():
        for key, want in state.items():
            got = torch_states[name][key]
            assert got.dtype == torch.int32, (name, key, got.dtype)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{name}.{key}")


def _run_both(jax_states, torch_states, jax_params, torch_params, steps, x, y):
    jm, tm = _jax_metrics(), port.make_metrics(CLASSES, "cpu")
    step = port.make_step(tm)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(steps):
        jloss, jax_params, jax_states, logits = _jax_step(jm, jax_params, jax_states, jx, jy)
        _assert_argmax_is_robust(logits)
        tloss, torch_params, torch_states = step(torch_params, torch_states, tx, ty)
        np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5, rtol=0)
        _assert_params_close(torch_params, jax_params)
        _assert_states_equal(torch_states, jax_states)
    for name in jm:
        np.testing.assert_allclose(
            tm[name].compute_from(torch_states[name]).numpy(),
            np.asarray(jm[name].compute_from(jax_states[name])),
            rtol=1e-6, atol=0,
        )
    return jax_states, torch_states


def test_fused_step_matches_jax():
    params, x, y = _numpy_inputs()
    jax_params = jax.tree_util.tree_map(jnp.asarray, params)
    torch_params = params_from_jax(params, device="cpu")
    jm = _jax_metrics()
    tm = port.make_metrics(CLASSES, "cpu")
    _run_both({k: m.init_state() for k, m in jm.items()}, {k: m.init_state() for k, m in tm.items()},
              jax_params, torch_params, STEPS, x, y)


def test_training_carries_over_from_jax_mid_run():
    """One step in JAX, then its parameters and metric states continue in the port."""
    params, x, y = _numpy_inputs(seed=1)
    jm = _jax_metrics()
    jax_params = jax.tree_util.tree_map(jnp.asarray, params)
    _, jax_params, jax_states, _ = _jax_step(jm, jax_params, {k: m.init_state() for k, m in jm.items()},
                                             jnp.asarray(x), jnp.asarray(y))
    torch_params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), device="cpu")
    torch_states = {k: metric_state_from_jax(jax.tree_util.tree_map(np.asarray, s), device="cpu")
                    for k, s in jax_states.items()}
    _assert_states_equal(torch_states, jax_states)
    _, torch_states = _run_both(jax_states, torch_states, jax_params, torch_params, STEPS - 1, x, y)
    assert int(torch_states["accuracy"]["_update_count"]) == STEPS


def test_params_from_jax_keeps_the_h_at_w_layout():
    params, _, _ = _numpy_inputs()
    converted = params_from_jax(params, device="cpu")
    assert [tuple(w.shape) for w in converted["ws"]] == [(HIDDEN, HIDDEN)] * LAYERS
    assert tuple(converted["head"].shape) == (HIDDEN, CLASSES) and converted["head"].dtype == torch.float32
    np.testing.assert_array_equal(converted["head"].numpy(), params["head"])


def test_entry_builds_the_full_width_config_on_the_gpu_by_default():
    assert port.FULL_CONFIG == {"batch": 1024, "hidden": 4096, "classes": 1000, "layers": 8}  # bench.py:90
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.entry()
    step, (params, states, x, y) = port.entry(device="cpu", seed=3, batch=16, hidden=8, classes=5, layers=1)
    loss, params, states = step(params, states, x, y)
    assert torch.isfinite(loss) and set(states) == {"accuracy", "f1", "confmat"}
    assert states["confmat"]["confmat"].shape == (5, 5) and int(states["confmat"]["confmat"].sum()) == 16
    assert set(step.metrics) == set(states)


def test_collection_step_matches_the_jax_collection_step():
    """The three metrics in a ``MetricCollection`` on both sides: one eager
    update forms the same groups ({accuracy, f1}, {confmat}); then the port's
    ``make_step(collection)`` runs against ``collection.update_state`` in the
    JAX step, with states bit-identical and values within rtol=1e-6."""
    from metrics_tpu.collections import MetricCollection as JaxCollection
    from metrics_tpu_torch.collections import MetricCollection

    params, x, y = _numpy_inputs()  # seed 0: no argmax tie within STEPS steps
    jcol, tcol = JaxCollection(_jax_metrics()), MetricCollection(port.make_metrics(CLASSES, "cpu"))
    first = np.array(jnp.argmax(_jax_forward(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
                                               jnp.asarray(y))[1], axis=-1))
    jcol.update(jnp.asarray(first), jnp.asarray(y))
    tcol.update(torch.from_numpy(first), torch.from_numpy(y))
    assert tcol.compute_groups == jcol.compute_groups == {0: ["accuracy", "f1"], 1: ["confmat"]}
    jax_params, torch_params = jax.tree_util.tree_map(jnp.asarray, params), params_from_jax(params, device="cpu")
    js, ts = jcol.init_state(), tcol.init_state()
    assert sorted(ts) == sorted(js) == ["accuracy", "confmat"]
    step = port.make_step(tcol)
    assert step.metrics is tcol
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(STEPS):
        (jloss, logits), grads = jax.value_and_grad(_jax_forward, has_aux=True)(jax_params, jx, jy)
        _assert_argmax_is_robust(logits)
        jax_params = jax.tree_util.tree_map(lambda p, g: p - 0.01 * g, jax_params, grads)
        js = jcol.update_state(js, jnp.argmax(logits, axis=-1), jy)
        tloss, torch_params, ts = step(torch_params, ts, tx, ty)
        np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5, rtol=0)
        _assert_states_equal(ts, js)
    jv, tv = jcol.compute_from(js), tcol.compute_from(ts)
    assert list(tv) == list(jv)
    for name in jv:
        np.testing.assert_allclose(tv[name].numpy(), np.asarray(jv[name]), rtol=1e-6, atol=0)
