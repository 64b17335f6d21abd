"""The port's utilities against the JAX package's, on the CPU.

Same numpy inputs through both. Integer outputs match exactly, int32
included; float outputs of ``_safe_divide`` and the weighted average within
rtol=1e-6 (float32 division and a float sum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.utils import compute as jax_compute
from metrics_tpu.utils import data as jax_data
from metrics_tpu.utils.enums import ClassificationTask as JaxTask
from metrics_tpu_torch.utils import compute, data
from metrics_tpu_torch.utils.enums import ClassificationTask


def _same(got, want, exact=True):
    want = np.asarray(want)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    if exact:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("topk,dim", [(1, 1), (2, 1), (3, 2), (1, 0)])
def test_select_topk_matches_jax(topk, dim):
    x = np.random.default_rng(topk + dim).standard_normal((6, 5, 4)).astype(np.float32)
    _same(data.select_topk(torch.from_numpy(x), topk, dim), jax_data.select_topk(jnp.asarray(x), topk, dim))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_to_onehot_matches_jax(dtype):
    labels = np.random.default_rng(0).integers(0, 4, (5, 3)).astype(dtype)
    got = data.to_onehot(torch.from_numpy(labels), 4)
    want = jax_data.to_onehot(jnp.asarray(labels), 4)
    assert got.shape == (5, 4, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["sum", "mean", "max", "min"])
def test_dim_zero_reductions_match_jax(name):
    x = np.random.default_rng(1).integers(-9, 9, (4, 3)).astype(np.int32)
    fn, jfn = getattr(data, f"dim_zero_{name}"), getattr(jax_data, f"dim_zero_{name}")
    arg = x.astype(np.float32) if name == "mean" else x
    _same(fn(torch.from_numpy(arg)), jfn(jnp.asarray(arg)))


def test_dim_zero_cat_and_flatten():
    parts = [np.arange(3, dtype=np.int32), np.array(7, dtype=np.int32)]
    _same(data.dim_zero_cat([torch.from_numpy(p) for p in parts]), jax_data.dim_zero_cat([jnp.asarray(p) for p in parts]))
    with pytest.raises(ValueError):
        data.dim_zero_cat([])
    assert data._flatten([[1, 2], [3]]) == [1, 2, 3]


def test_apply_to_collection_and_squeeze():
    nested = {"a": [torch.tensor([5]), torch.tensor([1, 2])], "b": (torch.tensor(3.0),)}
    out = data._squeeze_if_scalar(nested)
    assert out["a"][0].shape == () and out["a"][1].shape == (2,) and out["b"][0].shape == ()
    assert data.apply_to_collection({"x": 1, "y": "s"}, int, lambda v: v + 1) == {"x": 2, "y": "s"}


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_safe_divide_matches_jax(dtype):
    num = np.array([1, 0, 3, 5], dtype=dtype)
    den = np.array([2, 0, 0, 7], dtype=dtype)
    for zero_division in (0.0, 1.0):
        _same(
            compute._safe_divide(torch.from_numpy(num), torch.from_numpy(den), zero_division),
            jax_compute._safe_divide(jnp.asarray(num), jnp.asarray(den), zero_division),
            exact=False,
        )


@pytest.mark.parametrize("average", ["macro", "weighted", "none", None])
def test_adjust_weights_safe_divide_matches_jax(average):
    rng = np.random.default_rng(4)
    score = rng.random(6).astype(np.float32)
    tp = rng.integers(0, 9, 6).astype(np.int32)
    fn = rng.integers(0, 9, 6).astype(np.int32)
    got = compute._adjust_weights_safe_divide(torch.from_numpy(score), average, torch.from_numpy(tp), torch.from_numpy(fn))
    want = jax_compute._adjust_weights_safe_divide(jnp.asarray(score), average, jnp.asarray(tp), jnp.asarray(fn))
    _same(got, want, exact=False)


@pytest.mark.parametrize("text", ["binary", "MultiClass", "multilabel", "multi-class", "regression"])
def test_classification_task_lookup_matches_jax(text):
    want = JaxTask.from_str(text)
    got = ClassificationTask.from_str(text)
    assert (got is None) == (want is None) and (got is None or got.value == want.value)
    if want is None:
        with pytest.raises(ValueError, match="Invalid Classification"):
            ClassificationTask.from_str_or_raise(text)
    else:
        assert ClassificationTask.from_str_or_raise(text) == want.value.upper()
