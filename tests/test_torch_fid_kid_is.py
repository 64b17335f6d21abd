"""The port's FID, KID and Inception Score (``image/{fid,kid,inception}.py``)
against the JAX package's, on the CPU.

Two kinds of extractor feed both packages the same seeded images:
- a callable (the JAX tests' pattern: the first ``d`` pixels of each image as
  float32 features), where both packages see identical features;
- ``feature=64`` with carried weights: a torchvision-layout random state dict
  (``tools/torch_inception_fid.random_state_dict``, activations of order 1),
  converted to the flax layout and written to one ``.npz`` that both
  packages read through ``$METRICS_TPU_INCEPTION_WEIGHTS``.

Tolerances, and why:
- counts are int32 and equal bit for bit; with a callable extractor the
  float32 states are equal within 1e-6 of the state's largest magnitude
  (the same sums in another order: ``centered.T @ centered`` is a BLAS
  product in both, and the centred sums cancel);
- with the network the features differ by ~1e-6 relative (two float32
  convolution stacks), so the states within 1e-4 of their magnitude and
  the values within rtol 1e-3 (FID's trace is a difference of large traces);
- KID and IS draw their subsets from numpy's global state in both packages:
  under one ``np.random.seed`` the same subsets, values within rtol 1e-4
  (callable) and 1e-3 (network).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metrics_tpu.image as jax_img
import metrics_tpu_torch.image as port_img
from metrics_tpu.image import fid as jax_fid
from metrics_tpu.image import inception_net as jax_net
from metrics_tpu.utils.params_io import save_params as jax_save_params
from metrics_tpu_torch.image import fid as port_fid
from metrics_tpu_torch.image import inception_net as port_net

CPU = {"device": "cpu"}
D = 16


def jax_flatten(imgs):
    return jnp.asarray(imgs).reshape(imgs.shape[0], -1)[:, :D].astype(jnp.float32)


def port_flatten(imgs):
    return imgs.reshape(imgs.shape[0], -1)[:, :D].to(torch.float32)


def batches(seed, n_batches=3, n=24, size=8, shift=0.0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        x = shift + (1.0 - shift) * rng.random((n, 3, size, size))  # in [0, 1): uint8 casts stay in range
        out.append((x * 255).astype(np.uint8) if dtype == np.uint8 else x.astype(dtype))
    return out


def close(got, want, rtol, atol=0.0):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=rtol, atol=atol)


def same_states(port, ref, rtol):
    """Every state equal: int32 counts bit for bit, float32 states within
    ``rtol`` of the state's largest magnitude (the centred sums cancel, so an
    element's own magnitude says nothing of its rounding)."""
    assert list(port._defaults) == list(ref._defaults)
    for name in ref._defaults:
        a, b = getattr(port, name), getattr(ref, name)
        if isinstance(b, list):
            a, b = torch.cat(a), jnp.concatenate(b)
        if np.asarray(b).dtype == np.int32:
            assert a.dtype == torch.int32 and np.array_equal(a.numpy(), np.asarray(b)), name
        else:
            close(a, b, rtol, rtol * float(np.abs(np.asarray(b)).max()))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """One ``.npz`` of converted torchvision-layout weights for both packages."""
    from tools.convert_inception_weights import convert_state_dict
    from tools.torch_inception_fid import random_state_dict

    path = str(tmp_path_factory.mktemp("inception") / "weights.npz")
    jax_save_params(convert_state_dict(random_state_dict(seed=7)), path)
    return path


@pytest.fixture
def with_weights(weights, monkeypatch):
    monkeypatch.setenv("METRICS_TPU_INCEPTION_WEIGHTS", weights)
    return weights


def feed(port, ref, stream, **kw):
    for imgs, extra in stream:
        ref.update(jnp.asarray(imgs), **{**kw, **extra})
        port.update(torch.from_numpy(imgs), **{**kw, **extra})


def fid_stream(dtype=np.float32, size=8, n=24):
    real = batches(1, size=size, n=n, dtype=dtype)
    fake = batches(2, size=size, n=n, shift=0.2, dtype=dtype)
    return [(r, {"real": True}) for r in real] + [(f, {"real": False}) for f in fake]


@pytest.mark.parametrize("backend", ["scipy", "newton"])
@pytest.mark.parametrize("normalize", [False, True])
def test_fid_with_a_callable_extractor(backend, normalize):
    ref = jax_img.FrechetInceptionDistance(jax_flatten, num_features=D, sqrtm_backend=backend, normalize=normalize)
    port = port_img.FrechetInceptionDistance(port_flatten, num_features=D, sqrtm_backend=backend,
                                             normalize=normalize, **CPU)
    assert port._host_compute == ref._host_compute == (backend == "scipy")
    feed(port, ref, fid_stream(np.float32 if normalize else np.uint8))
    same_states(port, ref, rtol=1e-6)
    close(port.compute(), ref.compute(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("backend", ["scipy", "newton"])
def test_fid_at_feature_64_with_carried_weights(with_weights, backend):
    ref = jax_img.FrechetInceptionDistance(64, sqrtm_backend=backend)
    port = port_img.FrechetInceptionDistance(64, sqrtm_backend=backend, **CPU)
    assert port.num_features == ref.num_features == 64
    feed(port, ref, fid_stream(np.uint8, size=32, n=40))
    same_states(port, ref, rtol=1e-4)
    close(port.compute(), ref.compute(), rtol=1e-3, atol=1e-4)


def test_fid_singular_product_retry_and_the_newton_root():
    """Fewer samples than features: scipy's product is singular and the
    compute retries with eps on the diagonal, in both packages."""
    ref = jax_img.FrechetInceptionDistance(jax_flatten, num_features=D)
    port = port_img.FrechetInceptionDistance(port_flatten, num_features=D, **CPU)
    feed(port, ref, fid_stream(np.uint8, n=6)[:1] + fid_stream(np.uint8, n=6)[3:4])
    close(port.compute(), ref.compute(), rtol=1e-3, atol=1e-3)
    rng = np.random.default_rng(0)
    a = rng.normal(size=(D, 3 * D)).astype(np.float32)
    mat = (a @ a.T / (3 * D)).astype(np.float32)
    close(port_fid.sqrtm_newton_schulz(torch.from_numpy(mat)), jax_fid.sqrtm_newton_schulz(jnp.asarray(mat)),
          rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("reset_real", [True, False])
def test_fid_reset_real_features(reset_real):
    ref = jax_img.FrechetInceptionDistance(jax_flatten, num_features=D, reset_real_features=reset_real)
    port = port_img.FrechetInceptionDistance(port_flatten, num_features=D, reset_real_features=reset_real, **CPU)
    feed(port, ref, fid_stream(np.uint8))
    ref.reset()
    port.reset()
    same_states(port, ref, rtol=1e-6)
    assert int(port.real_features_num_samples) == (0 if reset_real else 72)
    assert int(port.fake_features_num_samples) == 0
    feed(port, ref, fid_stream(np.uint8)[3:])
    same_states(port, ref, rtol=1e-6)


@pytest.mark.parametrize("extractor", ["callable", "network"])
def test_kid_under_one_numpy_seed(weights, monkeypatch, extractor):
    if extractor == "network":
        monkeypatch.setenv("METRICS_TPU_INCEPTION_WEIGHTS", weights)
        kw, size, rtol = {"feature": 64}, 32, 1e-3
        ref_kw, port_kw = kw, kw
    else:
        size, rtol = 8, 1e-4
        ref_kw, port_kw = {"feature": jax_flatten}, {"feature": port_flatten}
    ref = jax_img.KernelInceptionDistance(**ref_kw, subsets=4, subset_size=20)
    port = port_img.KernelInceptionDistance(**port_kw, subsets=4, subset_size=20, **CPU)
    feed(port, ref, fid_stream(np.uint8, size=size))
    same_states(port, ref, rtol=1e-4 if extractor == "network" else 1e-6)
    np.random.seed(11)
    want = ref.compute()
    np.random.seed(11)
    got = port.compute()
    close(got[0], want[0], rtol=rtol, atol=1e-6)
    close(got[1], want[1], rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("reset_real", [True, False])
def test_kid_reset_real_features(reset_real):
    ref = jax_img.KernelInceptionDistance(jax_flatten, subset_size=10, reset_real_features=reset_real)
    port = port_img.KernelInceptionDistance(port_flatten, subset_size=10, reset_real_features=reset_real, **CPU)
    feed(port, ref, fid_stream(np.uint8))
    ref.reset()
    port.reset()
    assert len(port.real_features) == len(ref.real_features) == (0 if reset_real else 3)
    assert len(port.fake_features) == len(ref.fake_features) == 0


@pytest.mark.parametrize("extractor", ["callable", "network"])
@pytest.mark.parametrize("splits", [1, 4, 7])
def test_inception_score_under_one_numpy_seed(weights, monkeypatch, extractor, splits):
    if extractor == "network":
        monkeypatch.setenv("METRICS_TPU_INCEPTION_WEIGHTS", weights)
        ref_kw = port_kw = {"feature": 64}
        size, rtol = 32, 1e-3
    else:
        ref_kw, port_kw = {"feature": jax_flatten}, {"feature": port_flatten}
        size, rtol = 8, 1e-5
    ref = jax_img.InceptionScore(**ref_kw, splits=splits)
    port = port_img.InceptionScore(**port_kw, splits=splits, **CPU)
    for imgs in batches(3, size=size, dtype=np.uint8):
        ref.update(jnp.asarray(imgs))
        port.update(torch.from_numpy(imgs))
    same_states(port, ref, rtol=1e-4 if extractor == "network" else 1e-6)
    np.random.seed(5)
    want = ref.compute()
    np.random.seed(5)
    got = port.compute()
    close(got[0], want[0], rtol=rtol, atol=1e-6)
    if splits > 1:
        close(got[1], want[1], rtol=rtol, atol=1e-6)
    else:  # the spread of one split, ddof 1
        assert bool(torch.isnan(got[1])) and bool(jnp.isnan(want[1]))


ERRORS = [
    ("FrechetInceptionDistance", {"feature": 100}, ValueError),
    ("FrechetInceptionDistance", {"feature": "logits_bad"}, ValueError),
    ("FrechetInceptionDistance", {"feature": 1.5}, TypeError),
    ("FrechetInceptionDistance", {"feature": "callable"}, ValueError),  # no num_features
    ("FrechetInceptionDistance", {"feature": "callable", "num_features": 4, "reset_real_features": 1}, ValueError),
    ("FrechetInceptionDistance", {"feature": "callable", "num_features": 4, "normalize": 1}, ValueError),
    ("FrechetInceptionDistance", {"feature": "callable", "num_features": 4, "sqrtm_backend": "eig"}, ValueError),
    ("FrechetInceptionDistance", {"feature": 64}, FileNotFoundError),  # no weights
    ("KernelInceptionDistance", {"feature": "callable", "subsets": 0}, ValueError),
    ("KernelInceptionDistance", {"feature": "callable", "subset_size": -1}, ValueError),
    ("KernelInceptionDistance", {"feature": "callable", "degree": 0}, ValueError),
    ("KernelInceptionDistance", {"feature": "callable", "gamma": 1}, ValueError),
    ("KernelInceptionDistance", {"feature": "callable", "coef": 0.0}, ValueError),
    ("KernelInceptionDistance", {"feature": "callable", "reset_real_features": "yes"}, ValueError),
    ("KernelInceptionDistance", {"feature": "callable", "normalize": None}, ValueError),
    ("KernelInceptionDistance", {"feature": 7}, ValueError),
    ("InceptionScore", {"feature": "pool"}, ValueError),
    ("InceptionScore", {"feature": "callable", "splits": 0}, ValueError),
    ("InceptionScore", {"feature": "callable", "normalize": "no"}, ValueError),
    ("InceptionScore", {}, FileNotFoundError),  # the default logits head without weights
]


@pytest.mark.parametrize("cls,kw,err", ERRORS)
def test_the_argument_errors_of_the_jax_package(monkeypatch, cls, kw, err):
    monkeypatch.delenv("METRICS_TPU_INCEPTION_WEIGHTS", raising=False)
    for pkg, extractor, extra in ((jax_img, jax_flatten, {}), (port_img, port_flatten, CPU)):
        args = {k: (extractor if v == "callable" else v) for k, v in kw.items()}
        with pytest.raises(err):
            getattr(pkg, cls)(**args, **extra)


def test_kid_subset_larger_than_the_samples_raises_in_both():
    ref = jax_img.KernelInceptionDistance(jax_flatten, subset_size=100)
    port = port_img.KernelInceptionDistance(port_flatten, subset_size=100, **CPU)
    feed(port, ref, fid_stream(np.uint8))
    for m in (ref, port):
        with pytest.raises(ValueError, match="subset_size"):
            m.compute()


def test_one_network_is_shared_and_random_weights_need_opting_in(monkeypatch):
    monkeypatch.delenv("METRICS_TPU_INCEPTION_WEIGHTS", raising=False)
    fid = port_img.FrechetInceptionDistance(2048, allow_random_weights=True, **CPU)
    kid = port_img.KernelInceptionDistance(2048, allow_random_weights=True, **CPU)
    assert fid.extractor.net is kid.extractor.net and fid.num_features == 2048
    assert port_net._cached_net.cache_info().currsize >= 1


@pytest.mark.parametrize("module", ["fid", "kid", "inception"])
def test_docstring_examples_run(module):
    import doctest
    import importlib

    result = doctest.testmod(importlib.import_module(f"metrics_tpu_torch.image.{module}"), verbose=False)
    assert result.failed == 0 and result.attempted > 0
