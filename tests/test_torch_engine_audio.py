"""The fixed-state audio metrics served by the port's StreamingEngine against
the JAX package's engine, on the CPU.

``SignalNoiseRatio``, ``ScaleInvariantSignalNoiseRatio``,
``ScaleInvariantSignalDistortionRatio`` and ``SignalDistortionRatio`` hold a
float32 sum and an int32 total and no ``_host_compute``, so both engines fuse
them: every micro-batch is the masked scan (one CUDA-graph replay on the card,
a loop here), a row a signal. The same numpy-seeded stream (1-6 signals of 96
samples a request, 3 tenants) goes through both engines in one drained batch
each. The totals are equal bit for bit; the sums within rtol 1e-5 (the SNR
family: float32 sums of 96 squares in another order) and 1e-4 (SDR: a
16-tap Toeplitz solve a row, LAPACK on both sides); each state equals the
port's own row-by-row fold bit for bit.
"""

import numpy as np
import pytest
import torch

import metrics_tpu.audio as jax_audio
import metrics_tpu_torch.audio as torch_audio
from metrics_tpu.engine import StreamingEngine as JaxEngine
from metrics_tpu_torch.engine import StreamingEngine
from tests.test_torch_engine import (  # noqa: F401  (_one_torch_thread: the autouse fixture)
    _flat,
    _one_torch_thread,
    _stream,
    engine_states,
    fold_rows,
    run_stream,
)

CPU = {"device": "cpu"}


def _signals(rng, rows):
    target = rng.normal(size=(rows, 96)).astype(np.float32)
    return (target + 0.4 * rng.normal(size=target.shape)).astype(np.float32), target


# name -> (class, constructor arguments, rtol of the float32 sums)
SERVED = {
    "snr": ("SignalNoiseRatio", {}, 1e-5),
    "snr_zero_mean": ("SignalNoiseRatio", {"zero_mean": True}, 1e-5),
    "si_snr": ("ScaleInvariantSignalNoiseRatio", {}, 1e-5),
    "si_sdr": ("ScaleInvariantSignalDistortionRatio", {}, 1e-5),
    "sdr": ("SignalDistortionRatio", {"filter_length": 16}, 1e-4),
    "sdr_load_diag": ("SignalDistortionRatio", {"filter_length": 16, "load_diag": 1e-3}, 1e-4),
}


def _match(got, want, rtol, what):
    a, b = _flat(got), _flat(want)
    assert set(a) == set(b), (what, sorted(a), sorted(b))
    for path in a:
        x, y = a[path], b[path]
        assert x.dtype == y.dtype and x.shape == y.shape, (what, path, x.dtype, y.dtype)
        if np.issubdtype(x.dtype, np.floating):
            np.testing.assert_allclose(x, y, rtol=rtol, atol=1e-5, err_msg=f"{what} {path}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {path}")


@pytest.mark.parametrize("name", sorted(SERVED))
def test_fixed_state_audio_metrics_fuse_and_match_jax(name):
    cls, kw, rtol = SERVED[name]
    stream = _stream(_signals, seed=len(name), n=24, keys=3)
    ref = JaxEngine(getattr(jax_audio, cls)(**kw), buckets=(8,), capacity=4)
    port = StreamingEngine(getattr(torch_audio, cls)(**kw, **CPU), buckets=(8,), capacity=4)
    try:
        run_stream(ref, stream, one_drain=True)
        run_stream(port, stream, one_drain=True)
        p_snap, r_snap = port.telemetry_snapshot(), ref.telemetry_snapshot()
        p_states, r_states = engine_states(port), engine_states(ref)
        p_vals, r_vals = port.compute_all(), ref.compute_all()
    finally:
        port.close()
        ref.close()
    assert p_snap["fused"] and r_snap["fused"]
    assert p_snap["fused_fallbacks"] == r_snap["fused_fallbacks"] == 0
    assert p_snap["processed"] == r_snap["processed"] == len(stream)
    assert (p_snap["rows"], p_snap["batches"]) == (r_snap["rows"], r_snap["batches"])
    assert set(p_states) == set(r_states) and len(p_states) == 3
    folds = fold_rows(getattr(torch_audio, cls)(**kw, **CPU), stream)
    for key in r_states:
        _match(p_states[key], r_states[key], rtol, key)
        _match(p_vals[key], r_vals[key], rtol, key)
        for leaf, value in folds[key].items():
            assert torch.equal(torch.as_tensor(p_states[key][leaf]), torch.as_tensor(value)), (key, leaf)
