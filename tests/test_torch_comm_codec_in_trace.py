"""The int8 codec's in-trace twins against the JAX package's.

``Int8BlockCodec.encode_in_trace`` must give the JAX twin's int8 codes and
float32 scales bit for bit on the same float32 input (float32 division,
round half to even, the clamp to ±127), and ``decode_in_trace`` must give the
JAX decode bit for bit, leading world axes passing through. The host
``encode`` of the port is the third leg: the in-trace codes equal it too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.comm.codec import Int8BlockCodec as JaxInt8
from metrics_tpu_torch.comm.codec import Int8BlockCodec, get_codec


def _inputs(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return (rng.standard_normal(n) * 3).astype(np.float32)
    if kind == "zeros":
        return np.zeros(n, np.float32)
    if kind == "halves":  # x / scale lands on .5: round half to even decides
        x = (np.arange(n) % 255 - 127).astype(np.float32) / 2.0
        x[0] = 127.0  # absmax 127 → scale 1
        return x
    if kind == "ints":
        return rng.integers(-1000, 1000, n).astype(np.int32)
    raise ValueError(kind)


CASES = [("normal", 2000, 1024), ("normal", 1024, 1024), ("normal", 7, 4), ("zeros", 300, 128),
         ("halves", 2048, 1024), ("halves", 513, 64), ("ints", 1500, 256), ("normal", 1, 1024)]


@pytest.mark.parametrize("kind,n,block", CASES)
def test_encode_in_trace_equals_the_jax_twin_bit_for_bit(kind, n, block):
    x = _inputs(kind, n)
    codes, scales = Int8BlockCodec(block).encode_in_trace(torch.from_numpy(x))
    jcodes, jscales = JaxInt8(block).encode_in_trace(jnp.asarray(x))
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scales.numpy().view(np.uint32), np.asarray(jscales).view(np.uint32))
    host = Int8BlockCodec(block).encode(x)
    np.testing.assert_array_equal(codes.numpy(), host.payloads[0])
    np.testing.assert_array_equal(scales.numpy(), host.payloads[1])


@pytest.mark.parametrize("kind,n,block", CASES)
def test_decode_in_trace_equals_the_jax_decode_with_a_world_axis(kind, n, block):
    world = 3
    rows = [_inputs(kind, n, seed=r) for r in range(world)]
    enc = [JaxInt8(block).encode_in_trace(jnp.asarray(r)) for r in rows]
    jcodes = jnp.stack([c for c, _ in enc])
    jscales = jnp.stack([s for _, s in enc])
    want = np.asarray(JaxInt8(block).decode_in_trace(jcodes, jscales, n, jnp.float32))
    got = Int8BlockCodec(block).decode_in_trace(
        torch.from_numpy(np.asarray(jcodes)), torch.from_numpy(np.asarray(jscales)), n, torch.float32
    )
    assert got.shape == (world, n) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    # within the documented bound of each row's input, one block at a time
    for r, x in enumerate(rows):
        x = x.astype(np.float32)
        pad = -n % block
        absmax = np.abs(np.concatenate([x, np.zeros(pad, np.float32)])).reshape(-1, block).max(axis=1)
        # plus the float32 rounding of the reconstructed value
        bound = np.repeat(absmax / 254.0, block)[:n] + np.abs(x) * 2.0**-22
        assert np.all(np.abs(got[r].numpy() - x) <= bound)


def test_decode_in_trace_round_trips_one_row_and_keeps_the_target_dtype():
    codec = get_codec("int8")
    x = torch.from_numpy(_inputs("normal", 3000, seed=5))
    codes, scales = codec.encode_in_trace(x)
    out = codec.decode_in_trace(codes, scales, 3000, torch.float16)
    want = JaxInt8(1024).decode_in_trace(*JaxInt8(1024).encode_in_trace(jnp.asarray(x.numpy())), 3000, jnp.float16)
    assert out.dtype == torch.float16
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_empty_input_encodes_to_empty_payloads():
    codes, scales = Int8BlockCodec(16).encode_in_trace(torch.zeros(0))
    assert codes.shape == (0,) and scales.shape == (0,)
    assert Int8BlockCodec(16).decode_in_trace(codes, scales, 0, torch.float32).shape == (0,)
