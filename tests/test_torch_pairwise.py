"""The port's pairwise functionals (``functional/pairwise/similarity.py``)
against the JAX package's, on the CPU.

Cosine, euclidean, manhattan and linear over the same numpy inputs in both
packages, with ``y`` and in self mode, every ``reduction`` and every
``zero_diagonal``. The JAX package's eager CPU route (its BLAS products, the
float64 euclidean expansion clamped at 0, NaN rows of cosine for zero
vectors) is the reference. Tolerances: within rtol 1e-5, atol 1e-5 (float32
products in other orders; rows are of norm ~5). float64, float16 and int
inputs compute in float32 as in the JAX package. Errors are of the JAX
package's types.
"""

import doctest
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional as jax_fn
import metrics_tpu_torch.functional as torch_fn
import metrics_tpu_torch.functional.pairwise.similarity as torch_sim

RTOL, ATOL = 1e-5, 1e-5
KINDS = ["cosine_similarity", "euclidean_distance", "manhattan_distance", "linear_similarity"]


def close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype), (got.dtype, want.dtype)
    assert tuple(got.shape) == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol, equal_nan=True)


def run(kind, x, y=None, **kw):
    name = f"pairwise_{kind}"
    want = getattr(jax_fn, name)(jnp.asarray(x), None if y is None else jnp.asarray(y), **kw)
    got = getattr(torch_fn, name)(torch.from_numpy(x), None if y is None else torch.from_numpy(y), **kw)
    return got, want


@pytest.mark.parametrize("zero_diagonal", [None, True, False])
@pytest.mark.parametrize("reduction", [None, "none", "mean", "sum"])
@pytest.mark.parametrize("kind", KINDS)
def test_pairwise_matches_jax(kind, reduction, zero_diagonal):
    rng = np.random.default_rng(len(kind))
    x = rng.normal(size=(37, 24)).astype(np.float32)
    y = rng.normal(size=(29, 24)).astype(np.float32)
    close(*run(kind, x, y, reduction=reduction, zero_diagonal=zero_diagonal))
    close(*run(kind, x, reduction=reduction, zero_diagonal=zero_diagonal))  # self mode


@pytest.mark.parametrize("kind", KINDS)
def test_self_mode_pins_the_diagonal_unless_asked_not_to(kind):
    """Self mode's default diagonal is exactly 0; ``zero_diagonal=False`` keeps
    the raw values (for euclidean, the float64 expansion's), as in JAX."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(16, 8)) * 100).astype(np.float32)
    got, want = run(kind, x)
    assert torch.all(torch.diagonal(got) == 0)
    close(got, want)
    got, want = run(kind, x, zero_diagonal=False)
    close(got, want, atol=1e-3 if kind == "linear_similarity" else ATOL)


def test_euclidean_of_near_duplicate_rows_is_the_float64_expansion():
    """Rows that differ by ~1e-3 at a scale of 1e3 (and one identical pair):
    the float64 expansion, clamped at 0 after the cast back, reads them as the
    JAX CPU route does; a float32 expansion would be off by ~1 at this scale."""
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(12, 32)) * 1e3).astype(np.float32)
    y = (x + rng.normal(size=x.shape) * 1e-3).astype(np.float32)
    y[0] = x[0]
    got, want = run("euclidean_distance", x, y)
    close(got, want, rtol=1e-5, atol=1e-3)
    assert float(got[0, 0]) < 1e-3


def test_cosine_of_a_zero_row_is_nan_like_jax():
    x = np.array([[0.0, 0.0], [1.0, 2.0]], np.float32)
    y = np.array([[1.0, 1.0], [0.0, 0.0], [2.0, -1.0]], np.float32)
    got, want = run("cosine_similarity", x, y)
    assert torch.isnan(got[0]).all() and torch.isnan(got[:, 1]).all()
    close(got, want)


@pytest.mark.parametrize("dtype", [np.float64, np.float16, np.int32, np.int64])
@pytest.mark.parametrize("kind", KINDS)
def test_other_input_dtypes_compute_in_float32(kind, dtype):
    rng = np.random.default_rng(7)
    x, y = rng.normal(size=(10, 6)) * 3, rng.normal(size=(9, 6)) * 3
    x, y = ((a.astype(dtype) if np.issubdtype(dtype, np.floating) else np.rint(a).astype(dtype)) for a in (x, y))
    got, want = run(kind, x, y)
    assert got.dtype == torch.float32
    close(got, want)


def test_manhattan_tiles_give_the_untiled_matrix(monkeypatch):
    rng = np.random.default_rng(8)
    x, y = rng.normal(size=(23, 5)).astype(np.float32), rng.normal(size=(11, 5)).astype(np.float32)
    whole = torch_fn.pairwise_manhattan_distance(torch.from_numpy(x), torch.from_numpy(y))
    monkeypatch.setattr(torch_sim, "_MANHATTAN_TILE_ELEMENTS", 2 * 11 * 5)
    tiled = torch_fn.pairwise_manhattan_distance(torch.from_numpy(x), torch.from_numpy(y))
    assert torch.equal(whole, tiled)
    close(tiled, jax_fn.pairwise_manhattan_distance(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("kind", KINDS)
def test_errors_match_jax_types(kind):
    name = f"pairwise_{kind}"
    cases = [
        (np.zeros(4, np.float32), None, {}),
        (np.zeros((4, 3), np.float32), np.zeros((4, 2), np.float32), {}),
        (np.zeros((4, 3), np.float32), np.zeros(3, np.float32), {}),
        (np.ones((4, 3), np.float32), None, {"reduction": "max"}),
    ]
    for x, y, kw in cases:
        with pytest.raises(ValueError):
            getattr(jax_fn, name)(jnp.asarray(x), None if y is None else jnp.asarray(y), **kw)
        with pytest.raises(ValueError):
            getattr(torch_fn, name)(torch.from_numpy(x), None if y is None else torch.from_numpy(y), **kw)


def test_safe_matmul_upcasts_half_precision():
    from metrics_tpu.utils.compute import _safe_matmul as jax_safe_matmul
    from metrics_tpu_torch.utils.compute import _safe_matmul

    rng = np.random.default_rng(9)
    a, b = rng.normal(size=(8, 300)).astype(np.float16), rng.normal(size=(300, 5)).astype(np.float16)
    got = _safe_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float16
    close(got, jax_safe_matmul(jnp.asarray(a), jnp.asarray(b)), rtol=1e-3, atol=1e-2)
    a32 = a.astype(np.float32)
    close(_safe_matmul(torch.from_numpy(a32), torch.from_numpy(b.astype(np.float32))),
          jax_safe_matmul(jnp.asarray(a32), jnp.asarray(b.astype(np.float32))))


def test_docstring_examples_run():
    result = doctest.testmod(importlib.import_module("metrics_tpu_torch.functional.pairwise.similarity"), verbose=False)
    assert result.attempted > 0 and result.failed == 0
