"""The port's audio metrics (``functional/audio/`` and ``audio/``: SNR, SI-SNR,
SDR, SI-SDR, PIT, STOI, PESQ) against the JAX package's, on the CPU.

The same seeded numpy signals go through both packages' functionals and
modules, in float32, float64 (the JAX package sees it as float32, C.8) and
int32 / int64 (the SNR family raises ``ValueError`` on integers in both, as
``jnp.finfo`` does; SDR and STOI cast them to float32).

Tolerances, and why:
- SNR, SI-SNR, SI-SDR: rtol 1e-5, atol 1e-5 dB (float32 sums in another order);
- SDR: atol 1e-4 dB, rtol 1e-4 (an FFT and a 64- to 128-tap Toeplitz solve in
  float32 on each side, LAPACK in both; the filter's solve amplifies the
  rounding of the correlations); a silent target is exact: the singular solve
  gives NaN in both and the value is the clipped floor, 10 log10(eps / (1 - eps));
- PIT: the best permutations equal (int32), the values as their metric's;
- STOI and ESTOI: atol 1e-5 (float32 FFTs, band sums and norms);
- module states: float32 sums within the functionals' tolerance, int32
  totals equal.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metrics_tpu.audio as jax_audio
import metrics_tpu.functional.audio as jax_fn
import metrics_tpu_torch.audio as port_audio
import metrics_tpu_torch.functional.audio as port_fn

CPU = {"device": "cpu"}
SNR_FAMILY = ["signal_noise_ratio", "scale_invariant_signal_noise_ratio", "scale_invariant_signal_distortion_ratio"]


def signals(seed, shape=(3, 2, 800), dtype=np.float32, noise=0.3):
    rng = np.random.default_rng(seed)
    target = rng.normal(size=shape)
    preds = target + noise * rng.normal(size=shape)
    if np.issubdtype(dtype, np.integer):
        return (preds * 1000).astype(dtype), (target * 1000).astype(dtype)
    return preds.astype(dtype), target.astype(dtype)


def both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def close(got, want, rtol=1e-5, atol=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", SNR_FAMILY)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("zero_mean", [False, True])
def test_the_snr_family(name, dtype, zero_mean):
    (jp, jt), (tp, tt) = both(*signals(1, dtype=dtype))
    kw = {} if name == "scale_invariant_signal_noise_ratio" else {"zero_mean": zero_mean}
    close(getattr(port_fn, name)(tp, tt, **kw), getattr(jax_fn, name)(jp, jt, **kw))


@pytest.mark.parametrize("name", SNR_FAMILY)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_the_snr_family_refuses_integers_as_jax_does(name, dtype):
    (jp, jt), (tp, tt) = both(*signals(2, dtype=dtype))
    with pytest.raises(ValueError, match="not inexact"):
        getattr(jax_fn, name)(jp, jt)
    with pytest.raises(ValueError, match="not inexact"):
        getattr(port_fn, name)(tp, tt)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.int64])
@pytest.mark.parametrize("zero_mean", [False, True])
@pytest.mark.parametrize("load_diag", [None, 1e-3])
def test_sdr(dtype, zero_mean, load_diag):
    (jp, jt), (tp, tt) = both(*signals(3, dtype=dtype))
    kw = {"filter_length": 64, "zero_mean": zero_mean, "load_diag": load_diag}
    close(port_fn.signal_distortion_ratio(tp, tt, **kw), jax_fn.signal_distortion_ratio(jp, jt, **kw), 1e-4, 1e-4)


def test_sdr_on_a_silent_target_is_the_clipped_floor_in_both():
    preds, target = signals(4, shape=(2, 3, 600))
    target[0, 1] = 0.0
    target[1] = 0.0
    (jp, jt), (tp, tt) = both(preds, target)
    want = np.asarray(jax_fn.signal_distortion_ratio(jp, jt, filter_length=128))
    got = port_fn.signal_distortion_ratio(tp, tt, filter_length=128)
    floor = np.float32(10 * np.log10(np.finfo(np.float32).eps / (1 - np.finfo(np.float32).eps)))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_array_equal(got.numpy()[[0, 1, 1, 1], [1, 0, 1, 2]], want[[0, 1, 1, 1], [1, 0, 1, 2]])
    np.testing.assert_allclose(got.numpy()[1], floor, rtol=1e-6)
    close(got, want, 1e-4, 1e-4)


def test_sdr_shape_mismatch_raises_in_both():
    (jp, jt), (tp, tt) = both(*signals(5))
    for fn, p, t in ((jax_fn.signal_distortion_ratio, jp, jt[:, :1]), (port_fn.signal_distortion_ratio, tp, tt[:, :1])):
        with pytest.raises(RuntimeError, match="same shape"):
            fn(p, t)


@pytest.mark.parametrize("spk", [2, 3])
@pytest.mark.parametrize("eval_func", ["max", "min"])
@pytest.mark.parametrize("lsa", [None, True, False])
def test_pit(spk, eval_func, lsa):
    rng = np.random.default_rng(spk)
    target = rng.normal(size=(5, spk, 400)).astype(np.float32)
    order = [list(rng.permutation(spk)) for _ in range(5)]
    preds = np.stack([target[b, order[b]] for b in range(5)]) + 0.2 * rng.normal(size=target.shape)
    (jp, jt), (tp, tt) = both(preds.astype(np.float32), target)
    name = "scale_invariant_signal_distortion_ratio" if eval_func == "max" else "signal_noise_ratio"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_fn.permutation_invariant_training(jp, jt, getattr(jax_fn, name), eval_func,
                                                     use_linear_sum_assignment=lsa)
        got = port_fn.permutation_invariant_training(tp, tt, getattr(port_fn, name), eval_func,
                                                     use_linear_sum_assignment=lsa)
    close(got[0], want[0])
    assert got[1].dtype == torch.int32 and np.array_equal(got[1].numpy(), np.asarray(want[1]))
    close(port_fn.pit_permutate(tp, got[1]), jax_fn.pit_permutate(jp, want[1]), 0, 0)


def test_pit_ties_take_the_first_permutation_as_jax_does():
    target = np.ones((2, 3, 50), np.float32)
    (jp, jt), (tp, tt) = both(target.copy(), target)
    for eval_func in ("max", "min"):
        want = jax_fn.permutation_invariant_training(jp, jt, jax_fn.signal_noise_ratio, eval_func,
                                                     use_linear_sum_assignment=False)
        got = port_fn.permutation_invariant_training(tp, tt, port_fn.signal_noise_ratio, eval_func,
                                                     use_linear_sum_assignment=False)
        assert np.array_equal(got[1].numpy(), np.asarray(want[1])) and got[1].tolist() == [[0, 1, 2]] * 2


def test_pit_with_kwargs_and_the_errors():
    (jp, jt), (tp, tt) = both(*signals(7, shape=(2, 2, 300)))
    want = jax_fn.permutation_invariant_training(jp, jt, jax_fn.signal_distortion_ratio, filter_length=32)
    got = port_fn.permutation_invariant_training(tp, tt, port_fn.signal_distortion_ratio, filter_length=32)
    close(got[0], want[0], 1e-4, 1e-4)
    for fn, metric, p, t in ((jax_fn.permutation_invariant_training, jax_fn.signal_noise_ratio, jp, jt),
                             (port_fn.permutation_invariant_training, port_fn.signal_noise_ratio, tp, tt)):
        with pytest.raises(RuntimeError, match="batch and speaker"):
            fn(p, t[:, :1], metric)
        with pytest.raises(ValueError, match="eval_func"):
            fn(p, t, metric, "mean")
        with pytest.raises(ValueError, match="shape"):
            fn(p[0, 0], t[0, 0], metric)


@pytest.mark.parametrize("fs", [8000, 10000, 16000])
@pytest.mark.parametrize("extended", [False, True])
def test_stoi(fs, extended):
    rng = np.random.default_rng(fs)
    n = int(fs * 1.5)
    target = rng.normal(size=(3, n)).astype(np.float32)
    target[:, : n // 5] *= 1e-4  # a silent stretch: frames more than 40 dB down are dropped
    preds = (target + 0.5 * rng.normal(size=target.shape)).astype(np.float32)
    (jp, jt), (tp, tt) = both(preds, target)
    want = jax_fn.short_time_objective_intelligibility(jp, jt, fs, extended)
    got = port_fn.short_time_objective_intelligibility(tp, tt, fs, extended)
    close(got, want, 0, 1e-5)
    close(port_fn.short_time_objective_intelligibility(tp[0], tt[0], fs, extended),
          jax_fn.short_time_objective_intelligibility(jp[0], jt[0], fs, extended), 0, 1e-5)


@pytest.mark.parametrize("dtype", [np.float64, np.int32])
def test_stoi_of_other_dtypes(dtype):
    (jp, jt), (tp, tt) = both(*signals(8, shape=(2, 12000), dtype=dtype, noise=0.6))
    close(port_fn.short_time_objective_intelligibility(tp, tt, 16000),
          jax_fn.short_time_objective_intelligibility(jp, jt, 16000), 0, 1e-5)


def test_stoi_too_short_and_the_gates():
    (jp, jt), (tp, tt) = both(*signals(9, shape=(2, 3000)))
    with pytest.warns(RuntimeWarning, match="Not enough STFT"):
        want = jax_fn.short_time_objective_intelligibility(jp, jt, 10000)
    with pytest.warns(RuntimeWarning, match="Not enough STFT"):
        got = port_fn.short_time_objective_intelligibility(tp, tt, 10000)
    close(got, want, 0, 0)
    for fn, p, t in ((jax_fn.short_time_objective_intelligibility, jp, jt),
                     (port_fn.short_time_objective_intelligibility, tp, tt)):
        with pytest.raises(ValueError, match="backend"):
            fn(p, t, 8000, backend="scipy")
        with pytest.raises(ModuleNotFoundError, match="pystoi"):
            fn(p, t, 8000, backend="pystoi")
        with pytest.raises(ValueError, match="positive integer"):
            fn(p, t, 0)
        with pytest.raises(RuntimeError, match="same shape"):
            fn(p, t[:1], 8000)
    for cls in (jax_audio.ShortTimeObjectiveIntelligibility, port_audio.ShortTimeObjectiveIntelligibility):
        kw = CPU if cls is port_audio.ShortTimeObjectiveIntelligibility else {}
        with pytest.raises(ModuleNotFoundError, match="pystoi"):
            cls(8000, backend="pystoi", **kw)
        with pytest.raises(ValueError, match="backend"):
            cls(8000, backend="octave", **kw)


def test_the_pesq_gates():
    from metrics_tpu_torch.utils.imports import _PESQ_AVAILABLE, _PYSTOI_AVAILABLE

    assert not _PESQ_AVAILABLE and not _PYSTOI_AVAILABLE
    (jp, jt), (tp, tt) = both(*signals(10, shape=(2, 8000)))
    for fn, p, t in ((jax_fn.perceptual_evaluation_speech_quality, jp, jt),
                     (port_fn.perceptual_evaluation_speech_quality, tp, tt)):
        with pytest.raises(ModuleNotFoundError, match="pesq"):
            fn(p, t, 16000, "wb")
    with pytest.raises(ModuleNotFoundError, match="pesq"):
        jax_audio.PerceptualEvaluationSpeechQuality(16000, "wb")
    with pytest.raises(ModuleNotFoundError, match="pesq"):
        port_audio.PerceptualEvaluationSpeechQuality(16000, "wb", **CPU)


MODULES = {
    "snr": ("SignalNoiseRatio", {}, {}),
    "snr_zero_mean": ("SignalNoiseRatio", {"zero_mean": True}, {}),
    "si_snr": ("ScaleInvariantSignalNoiseRatio", {}, {}),
    "si_sdr": ("ScaleInvariantSignalDistortionRatio", {}, {}),
    "si_sdr_zero_mean": ("ScaleInvariantSignalDistortionRatio", {"zero_mean": True}, {}),
    "sdr": ("SignalDistortionRatio", {"filter_length": 64}, {"rtol": 1e-4, "atol": 1e-4}),
    "sdr_load_diag": ("SignalDistortionRatio", {"filter_length": 32, "load_diag": 1e-2, "zero_mean": True},
                      {"rtol": 1e-4, "atol": 1e-4}),
    "stoi": ("ShortTimeObjectiveIntelligibility", {"fs": 16000}, {"rtol": 0, "atol": 1e-5}),
    "estoi": ("ShortTimeObjectiveIntelligibility", {"fs": 8000, "extended": True}, {"rtol": 0, "atol": 1e-5}),
}


@pytest.mark.parametrize("key", sorted(MODULES))
def test_the_modules(key):
    cls, kw, tol = MODULES[key]
    ref = getattr(jax_audio, cls)(**kw)
    port = getattr(port_audio, cls)(**kw, **CPU)
    shape = (2, 2, 12000) if "stoi" in key else (3, 2, 500)
    for seed in range(2):
        (jp, jt), (tp, tt) = both(*signals(20 + seed, shape=shape, noise=0.6))
        ref.update(jp, jt)
        port.update(tp, tt)
    for name in ref._defaults:
        got, want = getattr(port, name), np.asarray(getattr(ref, name))
        if want.dtype == np.int32:
            assert got.dtype == torch.int32 and int(got) == int(want) == (8 if "stoi" in key else 12)
        else:
            close(got, want, **{"rtol": 1e-5, "atol": 1e-4, **tol})
    close(port.compute(), ref.compute(), **{"rtol": 1e-5, "atol": 1e-5, **tol})


def test_the_pit_module():
    ref = jax_audio.PermutationInvariantTraining(jax_fn.scale_invariant_signal_distortion_ratio, "max",
                                                 zero_mean=True)
    port = port_audio.PermutationInvariantTraining(port_fn.scale_invariant_signal_distortion_ratio, "max",
                                                   zero_mean=True, **CPU)
    assert port.kwargs == ref.kwargs == {"zero_mean": True} and port.device.type == "cpu"
    for seed in range(2):
        (jp, jt), (tp, tt) = both(*signals(30 + seed, shape=(4, 3, 300)))
        ref.update(jp, jt)
        port.update(tp, tt)
    close(port.sum_pit_metric, ref.sum_pit_metric, 1e-5, 1e-4)
    assert port.total.dtype == torch.int32 and int(port.total) == int(ref.total) == 8
    close(port.compute(), ref.compute())
    for cls, fn, kw in ((jax_audio.PermutationInvariantTraining, jax_fn.signal_noise_ratio, {}),
                        (port_audio.PermutationInvariantTraining, port_fn.signal_noise_ratio, CPU)):
        with pytest.raises(ValueError, match="eval_func"):
            cls(fn, "mean", **kw)


@pytest.mark.parametrize("module", [f"metrics_tpu_torch.{pkg}.{name}" for pkg in ("functional.audio", "audio")
                                    for name in ("snr", "sdr", "pit", "stoi")])
def test_docstring_examples_run(module):
    import doctest
    import importlib

    result = doctest.testmod(importlib.import_module(module), verbose=False)
    assert result.failed == 0 and result.attempted > 0
