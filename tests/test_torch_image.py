"""The port's image metrics that need no network (``functional/image/`` and
``image/``: PSNR, SSIM, MS-SSIM, UQI, ERGAS, SAM, D-lambda, total variation,
image gradients) against the JAX package's, on the CPU.

The same seeded numpy images go through both packages' functionals and
modules (``update``, ``forward``, ``compute``), with every option of the
JAX signatures, float64, float16 and integer inputs (the JAX package sees
float64 as float32, ROADMAP C.8), and bad input raising the JAX error type.

Tolerances, and why:
- SSIM, MS-SSIM, UQI and D-lambda: absolute error 2e-5 (float32), with
  rtol 1e-6 for the sums of many scores (``reduction="sum"``). Their window
  variances are differences, E[x^2] - mu^2, which cancel, and the JAX CPU
  product and torch's sum in other orders, so a relative tolerance alone on
  a value near 0 would be meaningless. float16: 5e-3.
- PSNR, ERGAS, SAM, TV: rtol 1e-5, atol 1e-5. The JAX package's CPU routes
  (PSNR's numpy float32 dot, ERGAS's numpy einsum) sum in other orders than
  the port's one torch form. float16: rtol 1e-2.
- ``torch.mean`` is not ``jnp.mean`` in the last bit: the reductions fall
  inside those tolerances.
- SAM per pixel in float16 (``reduction="none"``): atol 0.06. The angle is
  an arccos of a cosine near 1, where one float16 ulp of the cosine (the two
  packages round the squares and sums of the norms at other places) moves
  the angle by up to 0.05 rad; the mean and the sum hold the float16 rtol.
- The reflection pad and the image gradients are exact.
Fixed states are float32 (``TotalVariation.num_elements`` int32).
"""

import doctest
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional.image as jax_fn
import metrics_tpu.image as jax_img
import metrics_tpu_torch.functional.image as torch_fn
import metrics_tpu_torch.image as torch_img
from metrics_tpu.functional.image import helper as jax_helper
from metrics_tpu_torch.functional.image import helper as torch_helper

CPU = {"device": "cpu"}
SSIM_ATOL = 2e-5
RTOL, ATOL = 1e-5, 1e-5
HALF = {"rtol": 1e-2, "atol": 5e-3}


def close(got, want, rtol=RTOL, atol=ATOL, dtype=True):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w, rtol, atol, dtype)
        return
    want = np.asarray(want)
    got = got.detach().numpy()
    if dtype:
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=rtol, atol=atol)


def images(seed, shape=(2, 3, 24, 24), dtype=np.float32, scale=1.0):
    rng = np.random.default_rng(seed)
    preds = rng.random(shape) * scale
    target = preds * 0.75 + rng.random(shape) * 0.25 * scale
    if np.issubdtype(dtype, np.integer):
        return (preds * 100).astype(dtype), (target * 100).astype(dtype)
    return preds.astype(dtype), target.astype(dtype)


def both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def tol(dtype, ssim=False):
    if dtype == np.float16:
        return HALF
    return {"rtol": 1e-6, "atol": SSIM_ATOL} if ssim else {"rtol": RTOL, "atol": ATOL}


# ----------------------------------------------------------------- helper


@pytest.mark.parametrize("size,pad", [(6, 2), (6, 5), (3, 5), (2, 7), (1, 3), (5, 0)])
def test_reflection_pad_reflects_as_jnp_pad_even_past_the_side(size, pad):
    x = np.arange(2 * 3 * size * (size + 1), dtype=np.float32).reshape(2, 3, size, size + 1)
    close(torch_helper._reflection_pad(torch.from_numpy(x), [pad, pad]),
          jax_helper._reflection_pad(jnp.asarray(x), [pad, pad]))
    x3 = x.reshape(2, 3, 1, size, size + 1)
    close(torch_helper._reflection_pad(torch.from_numpy(x3), [0, pad, pad]),
          jax_helper._reflection_pad(jnp.asarray(x3), [0, pad, pad]))


def test_reflection_pad_of_an_empty_side_raises_the_jax_error():
    x = np.zeros((1, 1, 0, 4), np.float32)
    with pytest.raises(ValueError, match="empty axis"):
        jax_helper._reflection_pad(jnp.asarray(x), [2, 2])
    with pytest.raises(ValueError, match="empty axis"):
        torch_helper._reflection_pad(torch.from_numpy(x), [2, 2])


@pytest.mark.parametrize("k,sigma", [(11, 1.5), (7, 0.8), (1, 2.0)])
def test_gaussian_window_and_band_products(k, sigma):
    close(torch_helper._gaussian(k, sigma), jax_helper._gaussian(k, sigma), rtol=1e-6, atol=1e-7)
    f = np.random.default_rng(0).random(k).astype(np.float32)
    close(torch_helper._band_matrix(torch.from_numpy(f), 20, torch.float32),
          jax_helper._band_matrix(jnp.asarray(f), 20, jnp.float32))
    x = np.random.default_rng(1).random((2, 2, 20, 22)).astype(np.float32)
    close(torch_helper._depthwise_conv_separable(torch.from_numpy(x), [torch.from_numpy(f)] * 2),
          jax_helper._depthwise_conv_separable(jnp.asarray(x), [jnp.asarray(f)] * 2), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 3, 8, 10), (1, 2, 4, 6, 8)])
def test_avg_pool_matches_jax(shape):
    x = np.random.default_rng(2).random(shape).astype(np.float32)
    close(torch_helper._avg_pool(torch.from_numpy(x)), jax_helper._avg_pool(jnp.asarray(x)), rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------------- SSIM / MS-SSIM


SSIM_OPTIONS = [
    {},
    {"data_range": 1.0},
    {"gaussian_kernel": False, "kernel_size": 7},
    {"sigma": (1.0, 0.5), "data_range": 2.0},
    {"kernel_size": [5, 9], "gaussian_kernel": False, "k1": 0.02, "k2": 0.05},
    {"reduction": "sum"},
    {"reduction": "none"},
    {"return_full_image": True},
    {"return_contrast_sensitivity": True, "reduction": None},
]


@pytest.mark.parametrize("opts", SSIM_OPTIONS, ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()) or "default")
def test_ssim_functional_matches_jax(opts):
    (jp, jt), (tp, tt) = both(*images(0))
    close(torch_fn.structural_similarity_index_measure(tp, tt, **opts),
          jax_fn.structural_similarity_index_measure(jp, jt, **opts), **tol(np.float32, ssim=True))


@pytest.mark.parametrize("opts", [{}, {"data_range": 1.0, "gaussian_kernel": False, "kernel_size": 5},
                                  {"sigma": [1.0, 1.0, 0.7], "reduction": "none"}, {"return_full_image": True}])
def test_ssim_3d_matches_jax(opts):
    (jp, jt), (tp, tt) = both(*images(1, shape=(2, 1, 12, 14, 16)))
    close(torch_fn.structural_similarity_index_measure(tp, tt, **opts),
          jax_fn.structural_similarity_index_measure(jp, jt, **opts), **tol(np.float32, ssim=True))


@pytest.mark.parametrize("dtype", [np.float64, np.float16, np.int32, np.uint8, np.int64])
def test_ssim_input_dtypes_match_jax(dtype):
    (jp, jt), (tp, tt) = both(*images(2, dtype=dtype))
    close(torch_fn.structural_similarity_index_measure(tp, tt, data_range=100.0 if dtype != np.float16 else 1.0),
          jax_fn.structural_similarity_index_measure(jp, jt, data_range=100.0 if dtype != np.float16 else 1.0),
          **tol(dtype, ssim=True))


@pytest.mark.parametrize("kwargs,shape,match", [
    ({}, (2, 3, 8), "BxCxHxW"),
    ({"kernel_size": [3, 3, 3]}, (1, 1, 16, 16), "expected 2 for 2d"),
    ({"return_full_image": True, "return_contrast_sensitivity": True}, (1, 1, 16, 16), "mutually exclusive"),
    ({"kernel_size": 4, "gaussian_kernel": False}, (1, 1, 16, 16), "odd positive"),
    ({"sigma": -1.0}, (1, 1, 16, 16), "positive number"),
])
def test_ssim_errors_are_the_jax_errors(kwargs, shape, match):
    x = np.zeros(shape, np.float32)
    with pytest.raises(ValueError, match=match):
        jax_fn.structural_similarity_index_measure(jnp.asarray(x), jnp.asarray(x), **kwargs)
    with pytest.raises(ValueError, match=match):
        torch_fn.structural_similarity_index_measure(torch.from_numpy(x), torch.from_numpy(x), **kwargs)
    with pytest.raises(RuntimeError, match="same shape"):
        torch_fn.structural_similarity_index_measure(torch.zeros(1, 1, 16, 16), torch.zeros(1, 1, 16, 15))


MS_OPTIONS = [
    {"betas": (0.2, 0.3, 0.5), "data_range": 1.0},
    {"betas": (0.2, 0.3, 0.5), "normalize": "simple", "kernel_size": 5, "gaussian_kernel": False},
    {"betas": (0.5, 0.5), "normalize": None, "reduction": "none"},
    {"betas": (0.25, 0.25, 0.5), "reduction": "sum", "sigma": 1.0},
]


@pytest.mark.parametrize("opts", MS_OPTIONS, ids=range(len(MS_OPTIONS)))
def test_ms_ssim_functional_matches_jax(opts):
    (jp, jt), (tp, tt) = both(*images(3, shape=(2, 2, 64, 64)))
    close(torch_fn.multiscale_structural_similarity_index_measure(tp, tt, **opts),
          jax_fn.multiscale_structural_similarity_index_measure(jp, jt, **opts), **tol(np.float32, ssim=True))


@pytest.mark.parametrize("kwargs,shape,match", [
    ({"betas": [0.5, 0.5]}, (1, 1, 64, 64), "tuple of floats"),
    ({"normalize": "bogus"}, (1, 1, 64, 64), "either `None`"),
    ({"betas": (0.2, 0.3, 0.5)}, (1, 1, 64, 6), "larger than or equal to 8"),
    ({"betas": (0.2, 0.3, 0.5)}, (1, 1, 32, 64), "height must be larger than 40"),
])
def test_ms_ssim_errors_are_the_jax_errors(kwargs, shape, match):
    x = np.zeros(shape, np.float32)
    with pytest.raises(ValueError, match=match):
        jax_fn.multiscale_structural_similarity_index_measure(jnp.asarray(x), jnp.asarray(x), **kwargs)
    with pytest.raises(ValueError, match=match):
        torch_fn.multiscale_structural_similarity_index_measure(torch.from_numpy(x), torch.from_numpy(x), **kwargs)


# ----------------------------------------------------------------- PSNR


PSNR_OPTIONS = [
    {},
    {"data_range": 1.0},
    {"data_range": 2.0, "base": 2.0},
    {"data_range": 1.0, "dim": (1, 2, 3)},
    {"data_range": 1.0, "dim": 1, "reduction": "none"},
    {"data_range": 1.0, "dim": (2, 3), "reduction": "sum"},
    {"data_range": 1.0, "dim": ()},
]


@pytest.mark.parametrize("opts", PSNR_OPTIONS, ids=range(len(PSNR_OPTIONS)))
def test_psnr_functional_matches_jax(opts):
    (jp, jt), (tp, tt) = both(*images(4))
    close(torch_fn.peak_signal_noise_ratio(tp, tt, **opts), jax_fn.peak_signal_noise_ratio(jp, jt, **opts))


@pytest.mark.parametrize("dtype", [np.float64, np.float16, np.int32, np.int64])
def test_psnr_input_dtypes_match_jax(dtype):
    (jp, jt), (tp, tt) = both(*images(5, dtype=dtype))
    for opts in ({}, {"data_range": 100.0, "dim": (1, 2, 3)}):
        close(torch_fn.peak_signal_noise_ratio(tp, tt, **opts), jax_fn.peak_signal_noise_ratio(jp, jt, **opts),
              **tol(dtype))


def test_psnr_errors_are_the_jax_errors():
    x = np.zeros((1, 1, 4, 4), np.float32)
    with pytest.raises(ValueError, match="must be given when `dim`"):
        torch_fn.peak_signal_noise_ratio(torch.from_numpy(x), torch.from_numpy(x), dim=1)
    with pytest.raises(ValueError, match="must be given when `dim`"):
        torch_img.PeakSignalNoiseRatio(dim=1, **CPU)
    with pytest.warns(UserWarning, match="will not have any effect"):
        torch_fn.peak_signal_noise_ratio(torch.from_numpy(x) + 1, torch.from_numpy(x), data_range=1.0, reduction="sum")


# ----------------------------------------------------------------- UQI, ERGAS, SAM, D-lambda, TV, gradients


@pytest.mark.parametrize("opts", [{}, {"kernel_size": (5, 7), "sigma": (1.0, 2.0)}, {"reduction": "sum"},
                                  {"reduction": "none"}])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16, np.int32])
def test_uqi_functional_matches_jax(opts, dtype):
    (jp, jt), (tp, tt) = both(*images(6, dtype=dtype))
    close(torch_fn.universal_image_quality_index(tp, tt, **opts),
          jax_fn.universal_image_quality_index(jp, jt, **opts), **tol(dtype, ssim=True))


@pytest.mark.parametrize("opts", [{}, {"ratio": 2}, {"ratio": 0.5, "reduction": "sum"}, {"reduction": "none"}])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16, np.int32])
def test_ergas_functional_matches_jax(opts, dtype):
    (jp, jt), (tp, tt) = both(*images(7, dtype=dtype))
    close(torch_fn.error_relative_global_dimensionless_synthesis(tp, tt, **opts),
          jax_fn.error_relative_global_dimensionless_synthesis(jp, jt, **opts), **tol(dtype))


def test_ergas_lets_a_zero_mean_band_through_as_jax():
    p, t = images(8)
    t[0, 1] = 0.0
    (jp, jt), (tp, tt) = both(p, t)
    want = jax_fn.error_relative_global_dimensionless_synthesis(jp, jt, reduction="none")
    got = torch_fn.error_relative_global_dimensionless_synthesis(tp, tt, reduction="none")
    assert np.isinf(np.asarray(want)[0]) and torch.isinf(got[0])
    close(got[1:], np.asarray(want)[1:])


@pytest.mark.parametrize("opts", [{}, {"reduction": "sum"}, {"reduction": "none"}])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16, np.int32])
def test_sam_functional_matches_jax(opts, dtype):
    (jp, jt), (tp, tt) = both(*images(9, dtype=dtype))
    if dtype == np.float16 and opts.get("reduction") == "none":
        limits = {"rtol": 0.0, "atol": 0.06}
    else:
        limits = tol(dtype) if dtype != np.int32 else {"rtol": 1e-4, "atol": 1e-5}
    close(torch_fn.spectral_angle_mapper(tp, tt, **opts), jax_fn.spectral_angle_mapper(jp, jt, **opts), **limits)


@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_d_lambda_functional_matches_jax(p, reduction):
    (jp, jt), (tp, tt) = both(*images(10, shape=(2, 4, 20, 20)))
    close(torch_fn.spectral_distortion_index(tp, tt, p=p, reduction=reduction),
          jax_fn.spectral_distortion_index(jp, jt, p=p, reduction=reduction), **tol(np.float32, ssim=True))


def test_d_lambda_of_one_band_matches_jax():
    (jp, jt), (tp, tt) = both(*images(11, shape=(2, 1, 20, 20)))
    close(torch_fn.spectral_distortion_index(tp, tt), jax_fn.spectral_distortion_index(jp, jt),
          **tol(np.float32, ssim=True))


@pytest.mark.parametrize("reduction", ["sum", "mean", "none", None])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_total_variation_matches_jax(reduction, dtype):
    x = images(12, dtype=dtype)[0]
    close(torch_fn.total_variation(torch.from_numpy(x), reduction), jax_fn.total_variation(jnp.asarray(x), reduction))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_image_gradients_equal_jax(dtype):
    x = images(13, dtype=dtype)[0]
    got = torch_fn.image_gradients(torch.from_numpy(x))
    want = jax_fn.image_gradients(jnp.asarray(x))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("fn,args,err,match", [
    ("universal_image_quality_index", ((2, 3, 8),), ValueError, "BxCxHxW"),
    ("error_relative_global_dimensionless_synthesis", ((2, 3, 8),), ValueError, "BxCxHxW"),
    ("spectral_angle_mapper", ((2, 1, 8, 8),), ValueError, "larger than 1"),
    ("spectral_angle_mapper", ((2, 3, 8),), ValueError, "BxCxHxW"),
    ("spectral_distortion_index", ((2, 3, 8),), ValueError, "BxCxHxW"),
    ("total_variation", ((2, 3, 8),), RuntimeError, "4D tensor"),
    ("image_gradients", ((2, 3, 8),), RuntimeError, "4D tensor"),
])
def test_bad_shapes_raise_the_jax_errors(fn, args, err, match):
    x = np.zeros(args[0], np.float32)
    n = 1 if fn in ("total_variation", "image_gradients") else 2
    with pytest.raises(err, match=match):
        getattr(jax_fn, fn)(*[jnp.asarray(x)] * n)
    with pytest.raises(err, match=match):
        getattr(torch_fn, fn)(*[torch.from_numpy(x)] * n)


def test_other_argument_errors_are_the_jax_errors():
    x = torch.zeros(1, 2, 16, 16)
    with pytest.raises(ValueError, match="positive integer"):
        torch_fn.spectral_distortion_index(x, x, p=0)
    with pytest.raises(ValueError, match="length of two"):
        torch_fn.universal_image_quality_index(x, x, kernel_size=(3,))
    with pytest.raises(ValueError, match="either be 'sum'"):
        torch_fn.total_variation(x, "bogus")
    with pytest.raises(TypeError, match="array type"):
        torch_fn.image_gradients([1, 2])
    with pytest.raises(RuntimeError, match="same shape"):
        torch_fn.spectral_angle_mapper(x, x[:, :, :8])


# ----------------------------------------------------------------- modules


def _module_twins(name, kw):
    return getattr(jax_img, name)(**kw), getattr(torch_img, name)(**kw, **CPU)


MODULES = [
    ("StructuralSimilarityIndexMeasure", {}, True),
    ("StructuralSimilarityIndexMeasure", {"data_range": 1.0, "reduction": "sum"}, True),
    ("StructuralSimilarityIndexMeasure", {"reduction": "none"}, True),
    ("StructuralSimilarityIndexMeasure", {"return_full_image": True, "data_range": 1.0}, True),
    ("StructuralSimilarityIndexMeasure", {"return_contrast_sensitivity": True, "reduction": None}, True),
    ("MultiScaleStructuralSimilarityIndexMeasure", {"betas": (0.3, 0.7), "data_range": 1.0}, True),
    ("MultiScaleStructuralSimilarityIndexMeasure", {"betas": (0.3, 0.7), "reduction": "none", "normalize": None}, True),
    ("UniversalImageQualityIndex", {}, True),
    ("UniversalImageQualityIndex", {"reduction": "sum"}, True),
    ("UniversalImageQualityIndex", {"reduction": "none"}, True),
    ("ErrorRelativeGlobalDimensionlessSynthesis", {"ratio": 2}, False),
    ("ErrorRelativeGlobalDimensionlessSynthesis", {"reduction": "none"}, False),
    ("SpectralAngleMapper", {}, False),
    ("SpectralAngleMapper", {"reduction": "sum"}, False),
    ("SpectralDistortionIndex", {"p": 2}, True),
    ("SpectralDistortionIndex", {"reduction": "none"}, True),
    ("PeakSignalNoiseRatio", {}, False),
    ("PeakSignalNoiseRatio", {"data_range": 1.0, "base": 2.0}, False),
    ("PeakSignalNoiseRatio", {"data_range": 1.0, "dim": (1, 2, 3)}, False),
    ("PeakSignalNoiseRatio", {"data_range": 1.0, "dim": 1, "reduction": "none"}, False),
]


@pytest.mark.parametrize("name,kw,ssim_like", MODULES, ids=[f"{m[0]}-{i}" for i, m in enumerate(MODULES)])
def test_modules_match_jax(name, kw, ssim_like):
    j, t = _module_twins(name, kw)
    shape = (2, 3, 32, 32)
    batches = [images(s, shape=shape) for s in (20, 21, 22)]
    for i, arrays in enumerate(batches):
        (jp, jy), (tp, ty) = both(*arrays)
        if i == 1:
            close(t(tp, ty), j(jp, jy), **tol(np.float32, ssim=ssim_like))
        else:
            j.update(jp, jy)
            t.update(tp, ty)
    close(t.compute(), j.compute(), **tol(np.float32, ssim=ssim_like))
    for attr, default in t._defaults.items():
        if not isinstance(default, list):
            assert default.dtype == (torch.int32 if attr == "num_elements" else torch.float32), attr
    t.reset()
    j.reset()
    (jp, jy), (tp, ty) = both(*images(23, shape=shape))
    j.update(jp, jy)
    t.update(tp, ty)
    close(t.compute(), j.compute(), **tol(np.float32, ssim=ssim_like))


@pytest.mark.parametrize("dtype", [np.float64, np.float16, np.int32])
@pytest.mark.parametrize("name", ["PeakSignalNoiseRatio", "UniversalImageQualityIndex",
                                  "ErrorRelativeGlobalDimensionlessSynthesis", "SpectralAngleMapper"])
def test_fixed_states_stay_float32_whatever_the_input(name, dtype):
    j, t = _module_twins(name, {})
    (jp, jy), (tp, ty) = both(*images(24, dtype=dtype))
    j.update(jp, jy)
    t.update(tp, ty)
    for attr in t._defaults:
        assert getattr(t, attr).dtype == torch.float32, attr
        assert str(np.asarray(getattr(j, attr)).dtype) == "float32"
    close(t.compute(), j.compute(), **(tol(dtype, ssim=name == "UniversalImageQualityIndex")
                                       if dtype != np.int32 or name != "SpectralAngleMapper"
                                       else {"rtol": 1e-4, "atol": 1e-5}))


@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
def test_total_variation_module_matches_jax(reduction):
    j, t = jax_img.TotalVariation(reduction), torch_img.TotalVariation(reduction, **CPU)
    for seed in range(3):
        x = images(30 + seed, dtype=np.int32 if seed == 2 else np.float32)[0]
        if seed == 1:
            close(t(torch.from_numpy(x)), j(jnp.asarray(x)))
        else:
            j.update(jnp.asarray(x))
            t.update(torch.from_numpy(x))
    close(t.compute(), j.compute())
    assert t.num_elements.dtype == torch.int32 and int(t.num_elements) == int(j.num_elements) == 6
    with pytest.raises(ValueError, match="either be 'sum'"):
        torch_img.TotalVariation("bogus", **CPU)


def test_module_argument_errors_are_the_jax_errors():
    for name, kw, match in [
        ("StructuralSimilarityIndexMeasure", {"reduction": "bogus"}, "must be one of"),
        ("MultiScaleStructuralSimilarityIndexMeasure", {"betas": (1, 2)}, "tuple of floats"),
        ("MultiScaleStructuralSimilarityIndexMeasure", {"normalize": "bogus"}, "either `None`"),
        ("MultiScaleStructuralSimilarityIndexMeasure", {"kernel_size": 1.5}, "sequence or an int"),
        ("SpectralDistortionIndex", {"p": -1}, "positive integer"),
        ("SpectralDistortionIndex", {"reduction": "bogus"}, "be one of"),
    ]:
        with pytest.raises(ValueError, match=match):
            getattr(jax_img, name)(**kw)
        with pytest.raises(ValueError, match=match):
            getattr(torch_img, name)(**kw, **CPU)


def test_the_psnr_module_tracks_the_target_range_as_jax():
    """With ``data_range=None`` the module keeps the running target extremes,
    starting from 0 (a reference quirk kept in both packages)."""
    j, t = _module_twins("PeakSignalNoiseRatio", {})
    for seed, shift in ((40, 2.0), (41, 5.0)):
        p, y = images(seed)
        (jp, jy), (tp, ty) = both(p + shift, y + shift)
        j.update(jp, jy)
        t.update(tp, ty)
    close(t.min_target, j.min_target)
    close(t.max_target, j.max_target)
    close(t.compute(), j.compute())


@pytest.mark.parametrize("module", [f"metrics_tpu_torch.{pkg}.{name}" for pkg, names in (
    ("functional.image", ("gradients", "psnr", "ssim", "uqi", "ergas", "sam", "d_lambda", "tv")),
    ("image", ("psnr", "ssim", "uqi", "ergas", "sam", "d_lambda", "tv"))) for name in names])
def test_docstring_examples_run(module):
    result = doctest.testmod(importlib.import_module(module), verbose=False)
    assert result.failed == 0 and result.attempted > 0
