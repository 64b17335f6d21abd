"""The port's masked scan (``metrics_tpu_torch/kernels/engine_scan.py``) against
the JAX package's (``metrics_tpu/kernels/engine_scan.py``), on the CPU.

The same slab (tenant states built by a few updates), the same padded
micro-batch and the same mask go through the JAX bodies (``lax.scan``) and the
port's (torch loops, in place): the reference and the fused body of each
package give the same slab, integer leaves bit for bit with their dtype, float
leaves within rtol 1e-6. Masked rows never reach a tenant's state, whichever
body runs and however many of them there are.
"""

import jax
import numpy as np
import pytest
import torch

import metrics_tpu.engine as jeng
import metrics_tpu.kernels.engine_scan as jscan
import metrics_tpu_torch.engine as teng
import metrics_tpu_torch.kernels.engine_scan as tscan
from metrics_tpu_torch import obs
from metrics_tpu_torch.kernels import registry
from metrics_tpu_torch.obs import instrument
from tests.test_torch_engine import (  # noqa: F401  (_one_torch_thread: the autouse fixture)
    FAMILIES,
    _one_torch_thread,
    assert_trees_match,
    run_both,
)

CAPACITY = 4


def _slabs(family, seed):
    """A JAX and a port KeyedState holding the same three tenants' states."""
    make_jax, make_port, gen = FAMILIES[family]
    jm, tm = make_jax(), make_port()
    jks, tks = jeng.KeyedState(jm, capacity=CAPACITY), teng.KeyedState(tm, capacity=CAPACITY)
    rng = np.random.default_rng(seed)
    for key in ("a", "b", "c"):
        jks.slot_for(key)
        tks.slot_for(key)
        args = gen(rng, 3)
        jks.set_state(key, jm.update_state(jm.init_state(), *args))
        tks.set_state(key, tm.update_state(tm.init_state(), *map(torch.from_numpy, args)))
    return jm, tm, jks, tks


def _batch(family, seed, bucket, real):
    """``real`` rows for random tenants of a, b, c, padded to ``bucket``."""
    gen = FAMILIES[family][2]
    rng = np.random.default_rng(seed)
    reqs = [(int(rng.integers(0, 3)), gen(rng, 1), 1) for _ in range(real)]
    return reqs, jeng.pad_micro_batch(reqs, bucket), teng.pad_micro_batch(reqs, bucket)[:3]


CASES = [(family, bucket, real) for family in ("accuracy", "flagship", "quantile", "heavy_hitters", "mean", "auroc")
         for bucket, real in ((8, 5), (4, 4), (2, 1))]


@pytest.mark.parametrize("family,bucket,real", CASES, ids=[f"{f}-b{b}-r{r}" for f, b, r in CASES])
def test_both_bodies_match_jax(family, bucket, real):
    """Fused and reference bodies of both packages give one slab, at buckets
    above, at and below the tenant capacity."""
    jm, tm, jks, tks = _slabs(family, seed=bucket + real)
    _, (jcols, jkids, jmask), (tcols, tkids, tmask) = _batch(family, 7, bucket, real)
    want = jscan._reference_scan(jm.update_state, jks.stacked, jkids, jmask, jcols)
    np.testing.assert_equal(
        jax.tree.map(np.asarray, jscan._fused_scan(jm.update_state, jks.stacked, jkids, jmask, jcols)),
        jax.tree.map(np.asarray, want),
    )
    for body in (tscan._reference_scan, tscan._fused_scan):
        slab = teng.stream._clone_tree(tks.stacked)
        out = body(tm.update_state, slab, tkids, tmask, tcols)
        assert out is slab
        assert_trees_match(slab, want, body.__name__)


@pytest.mark.parametrize("body", [tscan._reference_scan, tscan._fused_scan])
def test_masked_rows_never_reach_a_tenant(body):
    """A micro-batch of padding only (every row masked, carrying tenant a's slot)
    leaves the slab as it was; so does the scratch row of the fused body."""
    _, tm, _, tks = _slabs("accuracy", seed=1)
    before = teng.stream._clone_tree(tks.stacked)
    _, _, (cols, kids, mask) = _batch("accuracy", 3, 8, 2)
    mask[:] = False
    body(tm.update_state, tks.stacked, kids, mask, cols)
    assert_trees_match(tks.stacked, before)


@pytest.mark.parametrize("body", [tscan._reference_scan, tscan._fused_scan])
def test_bodies_write_the_slab_in_place(body):
    """The slab's tensors are the ones a captured graph would replay into."""
    _, tm, _, tks = _slabs("flagship", seed=2)
    ptrs = [leaf.data_ptr() for leaf in tks.leaves()]
    _, _, (cols, kids, mask) = _batch("flagship", 4, 8, 6)
    body(tm.update_state, tks.stacked, kids, mask, cols)
    assert [leaf.data_ptr() for leaf in tks.leaves()] == ptrs


def test_scratch_row_never_leaks_between_tenants():
    """Single-row submits through a bucket of 32 (31 padding rows each): both
    engines give tenant a 1.0 and tenant b 0.0."""
    stream = [("a", (np.array([1], np.int32), np.array([1], np.int32))),
              ("b", (np.array([0], np.int32), np.array([1], np.int32)))]
    p_snap, r_snap, p_states, r_states, p_vals, r_vals = run_both("accuracy", stream, buckets=(32,), capacity=4)
    assert p_snap["fused_fallbacks"] == r_snap["fused_fallbacks"] == 0
    assert float(p_vals["a"]) == 1.0 and float(p_vals["b"]) == 0.0
    for key in ("a", "b"):
        assert_trees_match(p_states[key], r_states[key], key)


def test_eligibility_is_static_and_matches_jax():
    for bucket, capacity in ((256, 8), (8, 256), (8, 8), (1, 2)):
        assert tscan._eligible(bucket, capacity) == jscan._eligible(bucket, capacity) == (bucket >= capacity)
    assert registry.get(tscan.ENTRY).optimized is tscan._fused_scan
    assert registry.get(tscan.ENTRY).reference is tscan._reference_scan


@pytest.mark.parametrize("bucket,impl", [(8, "optimized"), (2, "reference")])
def test_masked_scan_update_selects_by_bucket_and_capacity(bucket, impl):
    """On every device the fused body serves bucket >= capacity and the reference
    the rest (one dispatch record each); the slab equals the JAX body's."""
    jm, tm, jks, tks = _slabs("quantile", seed=5)
    _, (jcols, jkids, jmask), (tcols, tkids, tmask) = _batch("quantile", 6, bucket, bucket)
    want = jscan._reference_scan(jm.update_state, jks.stacked, jkids, jmask, jcols)
    obs.enable()
    try:
        before = instrument.KERNEL_DISPATCHES.value(kernel=tscan.ENTRY, impl=impl)
        tscan.masked_scan_update(tm.update_state, tks.stacked, tkids, tmask, tcols)
        assert instrument.KERNEL_DISPATCHES.value(kernel=tscan.ENTRY, impl=impl) == before + 1
    finally:
        obs.disable()
    assert_trees_match(tks.stacked, want)


def test_a_state_laid_out_otherwise_is_refused():
    _, tm, _, tks = _slabs("accuracy", seed=1)
    _, _, (cols, kids, mask) = _batch("accuracy", 3, 4, 2)

    def reordered(state, *args):
        return dict(reversed(list(tm.update_state(state, *args).items())))

    with pytest.raises(ValueError, match="layout"):
        tscan._fused_scan(reordered, tks.stacked, kids, mask, cols)
