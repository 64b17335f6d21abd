"""Transfer plans against the JAX package's: for the same state (tensors in
the port, arrays in the JAX package), reductions and policy, ``build_plan``
gives the same signature, leaf routes and codecs, coalesced buffers (dtype,
op, slots, chunks, fast path) and ``collective_count``; the signature cache
hits and misses alike."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu import comm as jcomm
from metrics_tpu_torch import comm
from metrics_tpu_torch.comm.plan import device_tensor, host_array, np_dtype


def _states(seed=0):
    rng = np.random.default_rng(seed)
    leaves = {
        "total": np.float32(rng.standard_normal()),
        "tp": rng.integers(0, 50, 7).astype(np.int32),
        "maxv": rng.standard_normal(3).astype(np.float32),
        "minv": rng.standard_normal(3).astype(np.float32),
        "meanv": rng.standard_normal(5).astype(np.float32),
        "big": rng.standard_normal(3000).astype(np.float32),
        "preds": rng.standard_normal((1500, 2)).astype(np.float32),
        "vals": [rng.standard_normal(1200).astype(np.float32), rng.standard_normal(900).astype(np.float32)],
        "empty": [],
        "stacked": rng.standard_normal(3).astype(np.float32),
        "reduced": rng.standard_normal(4).astype(np.float32),
        "flags": rng.integers(0, 2, 9).astype(bool),
        "_update_count": np.int32(5),
    }

    def port(v):
        return [torch.from_numpy(x) for x in v] if isinstance(v, list) else torch.as_tensor(v)

    def ref(v):
        return [jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v)

    return {k: port(v) for k, v in leaves.items()}, {k: ref(v) for k, v in leaves.items()}


def _reds(pkg):
    return {"total": "sum", "tp": "sum", "maxv": "max", "minv": "min", "meanv": "mean", "big": "sum",
            "preds": "cat", "vals": "cat", "empty": "cat", "stacked": None,
            "reduced": (lambda g: g.sum(0)) if pkg == "port" else (lambda g: jnp.sum(g, axis=0)),
            "flags": "max"}


POLICIES = {
    "lossless": {},
    "int8": {"lossy": "int8"},
    "int8_reducible": {"lossy": "int8", "quantize_reducible": True},
    "fp16_small": {"lossy": "fp16", "min_bytes": 16},
}


def _plan_view(plan):
    leaves = [(lf.name, lf.route, lf.codec_name, lf.reduction_tag, lf.is_list, lf.shape, lf.dtype)
              for lf in plan.leaves]
    buffers = [(b.dtype, b.op, b.total, tuple((s.leaf, s.payload_idx, s.offset, s.size, s.shape) for s in b.slots),
                b.chunks, b.fast) for b in plan.buffers]
    return plan.signature, leaves, buffers, plan.has_update_count_extra, plan.collective_count


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("chunk_bytes,coalesce", [(4 << 20, True), (1024, True), (1024, False)])
@pytest.mark.parametrize("world", [None, 2, 3])
def test_plan_equals_the_jax_package(policy, chunk_bytes, coalesce, world):
    port_state, jax_state = _states()
    got = comm.build_plan(port_state, _reds("port"), comm.CodecPolicy(**POLICIES[policy]),
                          chunk_bytes=chunk_bytes, coalesce=coalesce, world=world)
    want = jcomm.build_plan(jax_state, _reds("jax"), jcomm.CodecPolicy(**POLICIES[policy]),
                            chunk_bytes=chunk_bytes, coalesce=coalesce, world=world)
    assert _plan_view(got) == _plan_view(want)


def test_flagship_collection_plan_equals_the_jax_package():
    """The flagship metrics' states as the engine syncs them (per member)."""
    from metrics_tpu.classification import MulticlassConfusionMatrix as JCM
    from metrics_tpu.classification import MulticlassF1Score as JF1
    from metrics_tpu_torch.classification import MulticlassConfusionMatrix, MulticlassF1Score

    for port_m, jax_m in ((MulticlassF1Score(50, device="cpu"), JF1(50)),
                          (MulticlassConfusionMatrix(50, device="cpu"), JCM(50))):
        got = comm.build_plan(port_m.init_state(), port_m._reductions, comm.CodecPolicy(), world=2)
        want = jcomm.build_plan(jax_m.init_state(), jax_m._reductions, jcomm.CodecPolicy(), world=2)
        assert _plan_view(got) == _plan_view(want)
        assert got.collective_count == 1  # every count leaf coalesces into one int32 buffer


def test_signature_cache_hits_and_misses_alike():
    comm.clear_plan_cache()
    jcomm.clear_plan_cache()
    port_state, jax_state = _states()
    for seed in (0, 1):  # a second state of the same skeleton is a hit
        port_state, jax_state = _states(seed)
        comm.build_plan(port_state, _reds("port"), comm.CodecPolicy(), world=2)
        jcomm.build_plan(jax_state, _reds("jax"), jcomm.CodecPolicy(), world=2)
    comm.build_plan(port_state, _reds("port"), comm.CodecPolicy(), world=3)
    jcomm.build_plan(jax_state, _reds("jax"), jcomm.CodecPolicy(), world=3)
    port_state["preds"] = port_state["preds"][:7]
    jax_state["preds"] = jax_state["preds"][:7]
    comm.build_plan(port_state, _reds("port"), comm.CodecPolicy(), world=3)
    jcomm.build_plan(jax_state, _reds("jax"), jcomm.CodecPolicy(), world=3)
    assert comm.plan_cache_info() == jcomm.plan_cache_info() == {"size": 3, "hits": 1, "misses": 3}
    comm.clear_plan_cache()
    assert comm.plan_cache_info() == {"size": 0, "hits": 0, "misses": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.int8, torch.bool, torch.float16, torch.int64])
def test_host_array_and_device_tensor_round_trip(dtype):
    x = torch.arange(6).reshape(2, 3).to(dtype)
    arr = host_array(x)
    assert arr.dtype == np_dtype(dtype) and arr.shape == (2, 3)
    back = device_tensor(arr, torch.device("cpu"))
    assert back.dtype == dtype and torch.equal(back, x)
    assert host_array(3).dtype == np.asarray(3).dtype
