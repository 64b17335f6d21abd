"""The count-min plane's kernels, in their own order of work, against the JAX
package, on the CPU.

``csrc/cms_walk.cu`` (the heavy-hitter ledger walk) and the ids route of
``csrc/scatter.cu`` (the count-min table from ids, columns hashed in the
kernel) run only on the GPU (``chip_smoke.py``). Here the arithmetic they
follow is held bit for bit against ``metrics_tpu.sketch.kernels``:

- ``scatter.ids_route_columns``: the columns as ``csrc/cm_hash.cuh`` computes
  them (uint32 lanes, the row seeds, ``% width`` or a mask), against JAX's
  ``_cm_columns``, with negative ids, ``INT32_MIN``/``MAX`` and widths 1, 7
  and 2048;
- ``cms_walk.walk_in_chunks``: the walk in chunks of 32 (an item's estimate
  is the cell before the chunk plus its rank plus one; only the items that can
  change the ledger reach the sequential decision), and the plain walk,
  against JAX's ``cms_update``, on the cases ``chip_smoke.py`` Phase A runs
  on the card, at smaller sizes.

The wrappers are held to their checks on ``meta`` tensors, where any host read
would raise: they reach the device check, and launch nothing. Tolerance: exact
equality, int32.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.sketch import kernels as J
from metrics_tpu_torch.kernels import cms_walk, scatter
from metrics_tpu_torch.sketch import kernels as T

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


# --------------------------------------------------------------------- the ids route


@pytest.mark.parametrize("width", [1, 7, 2048, 3, 65536])
@pytest.mark.parametrize("depth", [1, 4, 5])
def test_ids_route_columns_match_jax(depth, width):
    rng = np.random.default_rng(depth * 100003 + width)
    ids = np.concatenate([rng.integers(INT32_MIN, INT32_MAX, 2000), [INT32_MIN, INT32_MAX, -1, 0, 1]]).astype(np.int32)
    want = np.asarray(J._cm_columns(jnp.asarray(ids), depth, width))
    got = scatter.ids_route_columns(torch.from_numpy(ids), depth, width)
    assert got.dtype == torch.int32 and got.shape == (ids.size, depth)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("depth,width", [(4, 2048), (3, 7), (2, 1)])
def test_ids_route_table_update_matches_jax(depth, width):
    """The wrapper on the CPU (its plain version), and ``cms_table_update``."""
    rng = np.random.default_rng(width)
    ids = (rng.zipf(1.1, 5000) % 10**7).astype(np.int32)
    ids[::41] = -5
    ids[:2] = [INT32_MIN, INT32_MAX]
    counts = rng.integers(0, 9, (depth, width)).astype(np.int32)
    want = np.asarray(J.cms_table_update(jnp.asarray(counts), jnp.asarray(ids)))
    before = dict(scatter.launches)
    for got in (scatter.cms_ids_add_cuda(torch.from_numpy(counts), torch.from_numpy(ids)),
                scatter.cms_ids_add_reference(torch.from_numpy(counts), torch.from_numpy(ids)),
                T.cms_table_update(torch.from_numpy(counts), torch.from_numpy(ids))):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert scatter.launches == before


# --------------------------------------------------------------------- the walk


def _ledger(k, keys=(), counts=()):
    led = np.stack([np.full(k, -1, np.int32), np.zeros(k, np.int32)], axis=1)
    led[: len(keys), 0] = keys
    led[: len(counts), 1] = counts
    return led


def _walk_case(name):
    """(counts, ledger, ids) of a Phase A walk case, at a CPU test's size."""
    rng = np.random.default_rng(len(name) * 7919 + sum(map(ord, name)))
    depth, width, k, n = 4, 2048, 32, 1500
    ledger = None
    if name == "zipf":
        ids = (rng.zipf(1.1, n) % 10**7).astype(np.int32)
    elif name == "uniform":
        ids = rng.integers(0, 5000, n).astype(np.int32)
    elif name == "all_one_id":
        ids = np.full(n, 12345, np.int32)
    elif name == "negative_ids":
        ids = (rng.zipf(1.2, n) % 300).astype(np.int32)
        ids[rng.random(n) < 0.3] = -1
        ids[::50] = INT32_MIN
    elif name == "ties_at_the_minimum":  # every count equal: the first slot of the minimum goes first
        k = 8
        ledger = _ledger(k, keys=np.arange(100, 108), counts=np.full(8, 3))
        ids = rng.integers(0, 40, n).astype(np.int32)
    elif name == "nonempty_ledger":  # held keys with counts above and below their estimate, a duplicate key
        ledger = _ledger(k, keys=[5, 9, 5, 77, 1000], counts=[50, 1, 2, 0, 9])
        ids = (rng.zipf(1.3, n) % 60).astype(np.int32)
    elif name == "global_table_width_7":  # a width that is no power of two
        width = 7
        ids = (rng.zipf(1.1, n) % 1000).astype(np.int32)
    else:  # "k=<k>"
        k = int(name[2:])
        ids = (rng.zipf(1.15, n) % 3000).astype(np.int32)
    counts = rng.integers(0, 3, (depth, width)).astype(np.int32)
    return counts, _ledger(k) if ledger is None else ledger, ids


WALK_CASES = ["zipf", "uniform", "all_one_id", "negative_ids", "ties_at_the_minimum", "nonempty_ledger",
              "global_table_width_7", "k=1", "k=8", "k=32", "k=33", "k=100"]


@pytest.mark.parametrize("name", WALK_CASES)
def test_walk_in_chunks_and_the_plain_walk_match_jax(name):
    counts, ledger, ids = _walk_case(name)
    want_counts, want_ledger = (np.asarray(a) for a in J.cms_update(jnp.asarray(counts), jnp.asarray(ledger),
                                                                     jnp.asarray(ids)))
    args = (torch.from_numpy(counts), torch.from_numpy(ledger), torch.from_numpy(ids))
    got_counts, got_ledger, decided = cms_walk.walk_in_chunks(*args)
    for got, want in ((got_counts, want_counts), (got_ledger, want_ledger)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    valid = int((ids >= 0).sum())
    assert 0 < decided <= valid
    if name == "all_one_id":  # the id's count rises with every copy: each one is decided
        assert decided == valid
    before = cms_walk.launches
    for got, want in zip(cms_walk.cms_walk_cuda(*args), (want_counts, want_ledger)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert cms_walk.launches == before
    assert np.array_equal(args[0].numpy(), counts) and np.array_equal(args[1].numpy(), ledger)


def test_walk_in_chunks_skips_the_items_that_cannot_change_the_ledger():
    """On a Zipf stream most items are neither held nor above the smallest
    count once the ledger has filled: those take no sequential decision."""
    rng = np.random.default_rng(3)
    ids = (rng.zipf(1.1, 20000) % 10**7).astype(np.int32)
    _, _, decided = cms_walk.walk_in_chunks(torch.zeros((4, 2048), dtype=torch.int32), torch.from_numpy(_ledger(32)),
                                            torch.from_numpy(ids))
    assert decided < ids.size // 2


# --------------------------------------------------------------------- wrapper checks


def _meta(*shape, dtype=torch.int32):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize(
    "call,error,match",
    [
        (lambda: cms_walk.cms_walk_cuda(_meta(4, 64), _meta(8, 2), _meta(5)), ValueError, "CUDA device or the CPU"),
        (lambda: cms_walk.cms_walk_cuda(_meta(4, 64, dtype=torch.int64), _meta(8, 2), _meta(5)), TypeError,
         "2-D int32"),
        (lambda: cms_walk.cms_walk_cuda(_meta(64), _meta(8, 2), _meta(5)), TypeError, "2-D int32"),
        (lambda: cms_walk.cms_walk_cuda(_meta(4, 64), _meta(8, 3), _meta(5)), TypeError, r"\(k, 2\) int32"),
        (lambda: cms_walk.cms_walk_cuda(_meta(4, 64), _meta(8, 2, dtype=torch.int64), _meta(5)), TypeError,
         r"\(k, 2\) int32"),
        (lambda: cms_walk.cms_walk_cuda(_meta(4, 64), _meta(0, 2), _meta(5)), ValueError, "0 slots"),
        (lambda: cms_walk.cms_walk_cuda(_meta(4097, 2), _meta(8, 2), _meta(5)), ValueError, "CMS_MAX_DEPTH"),
        (lambda: cms_walk.cms_walk_cuda(_meta(4, 64), _meta(8, 2), _meta(5, dtype=torch.float32)), TypeError,
         "integer"),
        (lambda: cms_walk.cms_walk_cuda(_meta(4, 64), _meta(8, 2), _meta(4, 4).t()), ValueError, "contiguous"),
        (lambda: cms_walk.cms_walk_cuda(_meta(4, 64), torch.zeros((8, 2), dtype=torch.int32), _meta(5)), ValueError,
         "ledger is on cpu"),
        (lambda: cms_walk.cms_walk_cuda(_meta(4, 64), _meta(8, 2), _meta(5), _meta(1)), ValueError,
         "one int64"),
        (lambda: scatter.cms_ids_add_cuda(_meta(4, 64), _meta(5)), ValueError, "CUDA device or the CPU"),
        (lambda: scatter.cms_ids_add_cuda(_meta(64), _meta(5)), TypeError, "2-D int32"),
        (lambda: scatter.cms_ids_add_cuda(_meta(4097, 2), _meta(5)), ValueError, "CMS_MAX_DEPTH"),
        (lambda: scatter.cms_ids_add_cuda(_meta(4, 64), _meta(5, dtype=torch.float32)), TypeError, "integer"),
        (lambda: scatter.cms_ids_add_cuda(_meta(4, 64), _meta(4, 4).t()), ValueError, "contiguous"),
        (lambda: scatter.cms_ids_add_cuda(_meta(4, 64), torch.zeros(5, dtype=torch.int32)), ValueError,
         "ids is on cpu"),
    ],
)
def test_wrappers_check_before_launching(call, error, match):
    """Off the CPU a wrapper launches its kernel or raises, never the plain
    version; on ``meta`` tensors it gets to its device check without reading
    a value on the host (a host read of a meta tensor raises otherwise)."""
    before_walk, before_scatter = cms_walk.launches, dict(scatter.launches)
    with pytest.raises(error, match=match):
        call()
    assert cms_walk.launches == before_walk and scatter.launches == before_scatter


def test_the_largest_depth_passes_the_checks():
    """``CMS_MAX_DEPTH`` rows is within the limit: the wrappers get to the device check."""
    depth = scatter.CMS_MAX_DEPTH
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        cms_walk.cms_walk_cuda(_meta(depth, 2), _meta(8, 2), _meta(5))
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        scatter.cms_ids_add_cuda(_meta(depth, 2), _meta(5))


def test_sketch_update_on_a_non_cpu_tensor_goes_to_the_kernels():
    """``cms_update`` and ``cms_table_update`` off the CPU reach the kernel
    wrappers (which raise on ``meta``), never a plain version."""
    with pytest.raises(ValueError, match="cms_walk_cuda: tensors must lie on a CUDA device"):
        T.cms_update(_meta(4, 64), _meta(8, 2), _meta(5))
    with pytest.raises(ValueError, match="cms_rows_add_cuda: tensors must lie on a CUDA device"):
        T.cms_table_update(_meta(4, 64), _meta(5))


def test_kernel_sources_export_what_the_wrappers_bind():
    csrc = Path(cms_walk.__file__).parent.parent / "csrc"
    walk = (csrc / f"{cms_walk.KERNEL_NAME}.cu").read_text()
    for symbol in ("int cms_walk_launch(", "int cms_walk_placement(", "cms_walk_error_string(",
                   '#include "cm_hash.cuh"'):
        assert symbol in walk
    src = (csrc / f"{scatter.KERNEL_NAME}.cu").read_text()
    for symbol in ("int cms_ids_add_launch(", "int scatter_cms_ids_shared(", '#include "cm_hash.cuh"'):
        assert symbol in src
    # the header's constants are the sketch plane's
    header = (csrc / "cm_hash.cuh").read_text().lower()
    for constant in ("0x9e3779b9", "0x85ebca6b", "0xc2b2ae35"):
        assert constant in header
