"""The port's scatter kernels against the JAX package's, on the CPU.

The same seeded numpy inputs go through ``metrics_tpu.kernels.scatter`` (the
jnp references, and the Pallas wrappers in interpret mode) and through
``metrics_tpu_torch.kernels.scatter`` (the plain versions, the CUDA wrappers,
which take the plain version on CPU tensors, and the registry entries).
Tolerance: exact equality, int32. Table sizes cover both branches the CUDA
kernel takes on the card: tables that fit in a block's shared memory (up to
2**14 bins, 4 x 2048 cells) and tables that do not (2**16 bins, 4 x 65536
cells); on the CPU both run the plain version. The CUDA kernels themselves run
only on the GPU (``chip_smoke.py``); here their wrappers are held to their
device, dtype and shape checks on ``meta`` tensors.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.kernels import scatter as jax_scatter
from metrics_tpu_torch import obs
from metrics_tpu_torch.kernels import registry, scatter
from metrics_tpu_torch.obs import instrument

INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run beside the rest of the suite in parallel workers, some
    of which time a watchdog in fractions of a second: keep PyTorch's share of
    the CPU to one thread per test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


HIST = {
    "add": (jax_scatter.hist_add_reference, jax_scatter.hist_add_pallas, scatter.hist_add_reference,
            scatter.hist_add_cuda, "ddsketch_hist_add"),
    "max": (jax_scatter.hist_max_reference, jax_scatter.hist_max_pallas, scatter.hist_max_reference,
            scatter.hist_max_cuda, "hll_scatter_max"),
}


def _assert_hist_matches(op, bins, idx, vals, pallas=True):
    jax_ref, jax_pallas, ref, cuda, entry = HIST[op]
    want = np.asarray(jax_ref(jnp.asarray(bins), jnp.asarray(idx), jnp.asarray(vals)))
    if pallas:
        got = jax_pallas(jnp.asarray(bins), jnp.asarray(idx), jnp.asarray(vals), interpret=True)
        np.testing.assert_array_equal(np.asarray(got), want, err_msg="Pallas interpret")
    tb, ti, tv = torch.from_numpy(bins), torch.from_numpy(idx), torch.from_numpy(vals)
    for name, fn in (("reference", ref), ("cuda wrapper", cuda), ("registry", lambda *a: registry.dispatch(entry, *a))):
        out = fn(tb, ti, tv)
        assert out.dtype == torch.int32, name
        np.testing.assert_array_equal(out.numpy(), want, err_msg=name)
    assert np.array_equal(bins, tb.numpy()), "the input table must be left as it was"


# (n, n_bins, pallas): ragged N around the Pallas tile of 4096; the card's
# shared branch up to 2**14 bins (64 KB) and its global branch at 2**16
HIST_CASES = [
    (4097, 17, True),
    (5000, 2048, True),
    (9000, 2500, False),
    (4100, 2**14, False),
    (6000, 2**16, False),
    (5, 100, True),  # below the JAX package's MIN_SCATTER_SIZE, which the port does not have
]


@pytest.mark.parametrize("n,n_bins,pallas", HIST_CASES)
def test_hist_add_matches_jax(n, n_bins, pallas):
    rng = np.random.default_rng(n + n_bins)
    bins = rng.integers(0, 50, n_bins).astype(np.int32)
    idx = rng.integers(-5, n_bins + 5, n).astype(np.int32)  # out-of-range on both sides
    w = rng.integers(0, 2, n).astype(np.int32)  # 0/1 weights, as the DDSketch stores use
    _assert_hist_matches("add", bins, idx, w, pallas)


@pytest.mark.parametrize("n,n_bins,pallas", HIST_CASES)
def test_hist_max_matches_jax(n, n_bins, pallas):
    rng = np.random.default_rng(7 * n + n_bins)
    bins = rng.integers(0, 8, n_bins).astype(np.int32)
    idx = rng.integers(-5, n_bins + 5, n).astype(np.int32)
    vals = rng.integers(1, 22, n).astype(np.int32)
    _assert_hist_matches("max", bins, idx, vals, pallas)


def test_hist_add_signed_weights_and_wraparound():
    """int32 adds wrap modulo 2**32 in every version: order does not matter."""
    rng = np.random.default_rng(3)
    n = 4500
    bins = np.array([INT32_MAX - 3, INT32_MIN + 2, 0, 5], np.int32)
    idx = rng.integers(0, 4, n).astype(np.int32)
    w = rng.integers(-3, 4, n).astype(np.int32)
    _assert_hist_matches("add", bins, idx, w, pallas=False)


def test_hist_max_int32_extremes():
    rng = np.random.default_rng(4)
    n = 4500
    bins = rng.integers(-10, 10, 64).astype(np.int32)
    bins[:3] = [INT32_MIN, INT32_MAX, INT32_MIN]
    idx = rng.integers(-2, 66, n).astype(np.int32)
    vals = rng.choice(np.array([INT32_MIN, INT32_MAX, -7, 0, 9], np.int32), n)
    _assert_hist_matches("max", bins, idx, vals, pallas=True)


@pytest.mark.parametrize("op", ["add", "max"])
def test_hist_zero_weights_and_zipf_indices(op):
    rng = np.random.default_rng(5)
    n = 8192
    idx = (rng.zipf(1.1, n) % 3000).astype(np.int32)  # skewed keys
    vals = rng.integers(1, 30, n).astype(np.int32)
    vals[::3] = 0  # zero weights contribute nothing to add
    _assert_hist_matches(op, rng.integers(0, 3, 2048).astype(np.int32), idx, vals, pallas=False)


@pytest.mark.parametrize("op", ["add", "max"])
def test_hist_empty_batch_returns_the_table(op):
    bins = np.arange(10, dtype=np.int32)
    empty = np.zeros(0, np.int32)
    _, _, ref, cuda, _ = HIST[op]
    for fn in (ref, cuda):
        np.testing.assert_array_equal(fn(torch.from_numpy(bins), torch.from_numpy(empty), torch.from_numpy(empty)).numpy(), bins)


# (n, depth, width, pallas): 4 x 2048 is the default table (shared on the
# card), 4 x 65536 a wide one (global)
CMS_CASES = [(4096 + 123, 4, 2048, True), (4500, 3, 64, True), (5, 4, 2048, False), (6000, 4, 65536, False)]


@pytest.mark.parametrize("n,depth,width,pallas", CMS_CASES)
def test_cms_rows_add_matches_jax(n, depth, width, pallas):
    rng = np.random.default_rng(n + depth + width)
    counts = rng.integers(0, 9, (depth, width)).astype(np.int32)
    cols = rng.integers(0, width, (n, depth)).astype(np.int32)  # in range, as _cm_columns makes them
    valid = rng.integers(0, 2, n).astype(bool)
    want = np.asarray(jax_scatter.cms_rows_add_reference(jnp.asarray(counts), jnp.asarray(cols), jnp.asarray(valid)))
    if pallas:
        got = jax_scatter.cms_rows_add_pallas(jnp.asarray(counts), jnp.asarray(cols), jnp.asarray(valid), interpret=True)
        np.testing.assert_array_equal(np.asarray(got), want)
    args = (torch.from_numpy(counts), torch.from_numpy(cols), torch.from_numpy(valid))
    for out in (scatter.cms_rows_add_reference(*args), scatter.cms_rows_add_cuda(*args),
                registry.dispatch("cms_row_scatter", *args)):
        assert out.dtype == torch.int32 and out.shape == (depth, width)
        np.testing.assert_array_equal(out.numpy(), want)


def test_cms_rows_add_drops_out_of_range_columns():
    counts = torch.zeros((2, 4), dtype=torch.int32)
    cols = torch.tensor([[0, 3], [4, -1], [2, 2]], dtype=torch.int32)
    valid = torch.tensor([True, True, False])
    want = torch.tensor([[1, 0, 0, 0], [0, 0, 0, 1]], dtype=torch.int32)
    assert torch.equal(scatter.cms_rows_add_cuda(counts, cols, valid), want)
    assert torch.equal(scatter.cms_rows_add_reference(counts, cols, valid.to(torch.int32)), want)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    bins = torch.zeros(4, dtype=torch.int32)
    idx = torch.tensor([0, 1, 1, 3], dtype=torch.int32)
    w = torch.ones(4, dtype=torch.int32)
    before = dict(scatter.launches)
    obs.enable()
    try:
        instrument.KERNEL_DISPATCHES.clear()
        add = registry.dispatch("ddsketch_hist_add", bins, idx, w)
        mx = registry.dispatch("hll_scatter_max", bins, idx, idx)
        cms = registry.dispatch("cms_row_scatter", torch.zeros((1, 4), dtype=torch.int32), idx[:, None], w.bool())
        counted = {
            e: instrument.KERNEL_DISPATCHES.value(kernel=e, impl="reference")
            for e in ("ddsketch_hist_add", "hll_scatter_max", "cms_row_scatter")
        }
    finally:
        obs.disable()
    assert scatter.launches == before
    assert counted == {"ddsketch_hist_add": 1, "hll_scatter_max": 1, "cms_row_scatter": 1}
    assert add.tolist() == [1, 2, 0, 1] and mx.tolist() == [0, 1, 0, 3] and cms.tolist() == [[1, 2, 0, 1]]


def _meta(*shape, dtype=torch.int32):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize(
    "call,error,match",
    [
        (lambda: scatter.hist_add_cuda(_meta(8), _meta(8), _meta(8)), ValueError, "CUDA device or the CPU"),
        (lambda: scatter.hist_max_cuda(_meta(8), _meta(8), _meta(8)), ValueError, "CUDA device or the CPU"),
        (lambda: scatter.cms_rows_add_cuda(_meta(4, 8), _meta(5, 4), _meta(5, dtype=torch.bool)), ValueError,
         "CUDA device or the CPU"),
        (lambda: scatter.hist_add_cuda(_meta(8, dtype=torch.int64), _meta(8), _meta(8)), TypeError, "1-D int32"),
        (lambda: scatter.hist_add_cuda(_meta(2, 4), _meta(8), _meta(8)), TypeError, "1-D int32"),
        (lambda: scatter.hist_add_cuda(_meta(8), _meta(8, dtype=torch.float32), _meta(8)), TypeError, "integer"),
        (lambda: scatter.hist_max_cuda(_meta(8), _meta(8), _meta(8, dtype=torch.float32)), TypeError, "integer"),
        (lambda: scatter.hist_add_cuda(_meta(8), _meta(9), _meta(8)), ValueError, "9 elements"),
        (lambda: scatter.hist_add_cuda(_meta(8), _meta(4, 4).t(), _meta(16)), ValueError, "contiguous"),
        (lambda: scatter.hist_add_cuda(_meta(0), _meta(8), _meta(8)), ValueError, "out of range"),
        (lambda: scatter.cms_rows_add_cuda(_meta(4, 8), _meta(5, 3), _meta(5)), ValueError, r"\(N, 4\)"),
        (lambda: scatter.cms_rows_add_cuda(_meta(4, 8), _meta(5, 4), _meta(6)), ValueError, "5 elements"),
        (lambda: scatter.cms_rows_add_cuda(_meta(8), _meta(5, 4), _meta(5)), TypeError, "2-D int32"),
    ],
)
def test_cuda_wrappers_check_before_launching(call, error, match):
    """Off the CPU a wrapper launches its kernel or raises: never the plain version."""
    before = dict(scatter.launches)
    with pytest.raises(error, match=match):
        call()
    assert scatter.launches == before


@pytest.mark.parametrize(
    "entry,args",
    [
        ("ddsketch_hist_add", (_meta(8, dtype=torch.float32), _meta(8), _meta(8))),
        ("hll_scatter_max", (_meta(2, 4), _meta(8), _meta(8))),
        ("cms_row_scatter", (_meta(8), _meta(8, 1), _meta(8))),
        ("cms_row_scatter", (_meta(2**16, 2**15), _meta(8, 2**16), _meta(8))),  # a table of 2**31 cells
    ],
)
def test_registry_raises_for_an_ineligible_non_cpu_call(entry, args):
    with pytest.raises(ValueError, match="not eligible"):
        registry.dispatch(entry, *args)


def test_every_batch_size_is_eligible_off_the_cpu():
    """No MIN_SCATTER_SIZE floor: N = 0, 1 and 5 select the kernel on the card."""
    for n in (0, 1, 5, 1023):
        assert registry.selected("ddsketch_hist_add", _meta(16), _meta(n), _meta(n)) == "optimized"
        assert registry.selected("cms_row_scatter", _meta(4, 16), _meta(n, 4), _meta(n)) == "optimized"


def test_registry_entries():
    for name, ref, opt in (
        ("ddsketch_hist_add", scatter.hist_add_reference, scatter.hist_add_cuda),
        ("hll_scatter_max", scatter.hist_max_reference, scatter.hist_max_cuda),
        ("cms_row_scatter", scatter.cms_rows_add_reference, scatter.cms_rows_add_cuda),
    ):
        entry = registry.get(name)
        assert entry.reference is ref and entry.optimized is opt
    assert set(scatter.launches) == {"hist_add", "hist_max", "cms_rows_add"}


@pytest.mark.parametrize("op", ["add", "max"])
@pytest.mark.parametrize("offsets,n,n_bins", [((1, 1), 4099, 2**16), ((1, 2), 4097, 2**17), ((3, 0), 5, 2**16)])
def test_hist_views_at_a_storage_offset_match_jax(op, offsets, n, n_bins):
    """idx and val that are views at a storage offset, N % 4 != 0, on tables
    beyond one block's shared memory on the card (its packed and global
    branches): on the CPU the wrappers take the plain version, which
    must read the views as the JAX package reads the same values."""
    rng = np.random.default_rng(n + n_bins + offsets[1])
    bins = rng.integers(0, 9, n_bins).astype(np.int32)
    idx_buf = rng.integers(-3, n_bins + 3, n + offsets[0]).astype(np.int32)
    val_buf = rng.integers(-40000, 40000, n + offsets[1]).astype(np.int32)  # beyond int16 too
    ti = torch.from_numpy(idx_buf)[offsets[0]:]
    tv = torch.from_numpy(val_buf)[offsets[1]:]
    assert ti.storage_offset() == offsets[0] and tv.storage_offset() == offsets[1] and ti.is_contiguous()
    jax_ref, _, _, cuda, _ = HIST[op]
    want = np.asarray(jax_ref(jnp.asarray(bins), jnp.asarray(idx_buf[offsets[0]:]), jnp.asarray(val_buf[offsets[1]:])))
    np.testing.assert_array_equal(cuda(torch.from_numpy(bins), ti, tv).numpy(), want)


def test_kernel_source_exports_what_the_wrapper_binds():
    src = (Path(scatter.__file__).parent.parent / "csrc" / f"{scatter.KERNEL_NAME}.cu").read_text()
    for symbol in ("int hist_add_launch(", "int hist_max_launch(", "int cms_rows_add_launch(",
                   "int scatter_uses_shared(", "int scatter_hist_branch(", "scatter_error_string("):
        assert symbol in src
    # the branch codes the wrapper names, in the source's order
    assert "0 global, 1 shared, 2 packed" in src
    assert scatter.HIST_BRANCHES == ("global", "shared", "packed")
