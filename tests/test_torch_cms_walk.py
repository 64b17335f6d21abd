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
- ``cms_walk.walk_in_chunks``: the walk in the kernels' order of work (the
  estimates from segment histograms, their scan and ranks; chunks of 32 with a
  snapshot of the keys, the raises before a candidate applied in no order,
  each candidate decided exactly), and the plain walk, against JAX's
  ``cms_update``, on the cases ``chip_smoke.py`` Phase A runs on the card, at
  smaller sizes, on cases built to put a candidate at either end of a chunk,
  a raise of the smallest count before a candidate, held no-ops, duplicate
  and negative keys and counts that wrap near 2^31, and on a seeded sweep;
  its raise and eviction counts against a plain sequential count.

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
    """(counts, ledger, ids) of a walk case, at a CPU test's size."""
    if name in CRAFTED:
        return _crafted_case(name)
    if name.startswith("sweep"):
        return _sweep_case(name)
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


HELD = np.arange(5000, 5032, dtype=np.int32)  # the keys of a full ledger in the crafted cases
NEW, NEW2 = 777777, 888888  # ids with high counts in the table: estimates above every ledger count


def _set_cells(counts, ids, value):
    depth, width = counts.shape
    cols = scatter.ids_route_columns(torch.as_tensor(np.asarray(ids, np.int32)), depth, width).numpy()
    counts[np.arange(depth)[None, :], cols] = value


def _crafted_case(name):
    """Cases built around one chunk of 32: a candidate (an id the ledger does
    not hold, with an estimate above its smallest count) at lane 0 or lane
    31; a raise that lifts the slot at the minimum before a candidate in the
    same chunk (the candidate must take the next slot: applied after it, the
    raise would leave it the first slot); held keys whose counts are above
    every estimate; duplicate and negative keys; counts that wrap near 2^31."""
    rng = np.random.default_rng(sum(map(ord, name)))
    counts = np.full((4, 2048), 3, np.int32)
    filler = lambda m: rng.integers(10**6, 10**6 + 10**5, m).astype(np.int32)  # noqa: E731  estimates ~4
    ledger = _ledger(32, keys=HELD, counts=40 + np.arange(32))
    _set_cells(counts, HELD, 25)  # a held key's estimate ~26: below its count, a raise that changes nothing
    ids = filler(8 * 32)
    if name in ("candidate_at_lane_0", "candidate_at_lane_31"):
        _set_cells(counts, [NEW, NEW2], 100)
        _set_cells(counts, HELD[:8], 60)  # raises that lift counts (and the minimum) on the way
        lane = 0 if name.endswith("_0") else 31
        for chunk in range(8):
            ids[chunk * 32:(chunk + 1) * 32] = rng.choice(HELD[:12], 32)
        ids[2 * 32 + lane], ids[5 * 32 + lane] = NEW, NEW2
    elif name == "raise_at_the_minimum_before_a_candidate":
        ledger[:, 1] = 40 + np.arange(32)
        ledger[3, 1], ledger[7, 1] = 10, 20  # slot 3 the minimum, slot 7 the next
        _set_cells(counts, HELD[3:4], 29)  # its estimate: 30, above slot 7's count
        _set_cells(counts, [NEW], 100)
        ids[32 + 4], ids[32 + 9] = HELD[3], NEW
    elif name == "held_no_ops":  # counts above every estimate: nothing in the ledger moves
        ledger[:, 1] = 10**6
        ids = rng.choice(np.r_[HELD, filler(32)], 1500).astype(np.int32)
    elif name == "duplicate_and_negative_keys":
        ledger = _ledger(32, keys=[5, 5, -1, -7, 9, 5, INT32_MIN, 12, 9], counts=[4, 9, 0, 3, 1, 2, 5, 0, 7])
        counts = rng.integers(0, 3, (4, 2048)).astype(np.int32)
        ids = rng.choice(np.array([5, 9, 12, -1, -7, INT32_MIN, 40, 41, 42, 43], np.int32), 1500)
    else:  # "wrap_near_2p31": hot cells pass INT32_MAX, estimates turn negative; counts at the top
        counts = np.full((4, 2048), INT32_MAX - 40, np.int32)
        ledger = _ledger(32, keys=[3, 4], counts=[INT32_MAX, INT32_MAX - 30])
        ids = (rng.zipf(1.3, 1500) % 50).astype(np.int32)
    return counts, ledger, ids


def _sweep_case(name):
    """``sweep_k<k>_w<width>_s<seed>``: a random start ledger (stream keys,
    duplicates, counts 0-20), a random table, Zipf ids with 10% negative."""
    k, width, seed = (int(part[1:]) for part in name.split("_")[1:])
    rng = np.random.default_rng(1000 * k + width + seed)
    depth, n = 3 + seed, 700
    ids = (rng.zipf(1.2, n) % 200).astype(np.int32)
    ids[rng.random(n) < 0.1] = -2
    m = int(rng.integers(0, k + 1))
    ledger = _ledger(k, keys=rng.choice(ids, m), counts=rng.integers(0, 21, m))
    return rng.integers(0, 6, (depth, width)).astype(np.int32), ledger, ids


CRAFTED = ["candidate_at_lane_0", "candidate_at_lane_31", "raise_at_the_minimum_before_a_candidate", "held_no_ops",
           "duplicate_and_negative_keys", "wrap_near_2p31"]
SWEEP = [f"sweep_k{k}_w{w}_s{s}" for k in (1, 8, 32, 33) for w in (7, 2048) for s in (0, 1)]
WALK_CASES = ["zipf", "uniform", "all_one_id", "negative_ids", "ties_at_the_minimum", "nonempty_ledger",
              "global_table_width_7", "k=1", "k=8", "k=32", "k=33", "k=100"] + CRAFTED + SWEEP


def _sequential_counts(counts, ledger, ids):
    """(raises, evictions) of the walk one item at a time in numpy: items whose
    key the ledger held at their time, and items that took a slot."""
    depth, width = counts.shape
    flat = counts.astype(np.int64).reshape(-1)
    cells = np.arange(depth) * width + scatter.ids_route_columns(torch.from_numpy(ids), depth, width).numpy()
    keys, cnts = ledger[:, 0].copy(), ledger[:, 1].astype(np.int64)
    raises = evictions = 0
    for x, at in zip(ids, cells):
        if x < 0:
            continue
        flat[at] = (flat[at] + 1 + 2**31) % 2**32 - 2**31
        est = flat[at].min()
        present = keys == x
        if present.any():
            raises += 1
            cnts = np.where(present, np.maximum(cnts, est), cnts)
        elif est > cnts.min():
            evictions += 1
            s = int(np.argmin(cnts))
            keys[s], cnts[s] = x, est
    return raises, evictions


@pytest.mark.parametrize("name", WALK_CASES)
def test_walk_in_chunks_and_the_plain_walk_match_jax(name):
    counts, ledger, ids = _walk_case(name)
    want_counts, want_ledger = (np.asarray(a) for a in J.cms_update(jnp.asarray(counts), jnp.asarray(ledger),
                                                                     jnp.asarray(ids)))
    args = (torch.from_numpy(counts), torch.from_numpy(ledger), torch.from_numpy(ids))
    got_counts, got_ledger, walked = cms_walk.walk_in_chunks(*args)
    for got, want in ((got_counts, want_counts), (got_ledger, want_ledger)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert (walked.raises, walked.evictions) == _sequential_counts(counts, ledger, ids)
    chunks = -(-ids.size // cms_walk.CHUNK)
    assert walked.evictions <= walked.snapshot_items and walked.sequential_chunks <= chunks
    if name == "all_one_id":  # the first copy takes a slot; every later one raises it
        assert (walked.raises, walked.evictions) == (ids.size - 1, 1)
    if name == "held_no_ops":
        assert walked.evictions == 0 and np.array_equal(want_ledger, ledger)
    if name == "raise_at_the_minimum_before_a_candidate":  # the raise went first: slot 7 was the minimum
        assert want_ledger[7, 0] == NEW and want_ledger[3, 0] == HELD[3] and walked.sequential_chunks == 1
    if name.startswith("candidate_at_lane"):  # the two, then the keys they evicted coming back
        assert walked.evictions >= 2 and walked.sequential_chunks >= 2
    if name == "wrap_near_2p31":
        assert (want_counts < 0).any() and (want_ledger[:, 1] == INT32_MAX).any()
    before = cms_walk.launches
    for got, want in zip(cms_walk.cms_walk_cuda(*args), (want_counts, want_ledger)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert cms_walk.launches == before
    assert np.array_equal(args[0].numpy(), counts) and np.array_equal(args[1].numpy(), ledger)


def test_walk_in_chunks_skips_the_items_that_cannot_change_the_ledger():
    """On a Zipf stream of a heavy-hitter batch (2^17 ids) fewer than 5% of
    the chunks reach a candidate; the rest apply their raises at once. Every
    chunk that holds an eviction is one of them, so the share is a property of
    the ids: on the first 20,000 ids of this stream 65 of 625 chunks hold one."""
    rng = np.random.default_rng(3)
    ids = (rng.zipf(1.1, 2**17) % 10**7).astype(np.int32)
    _, _, walked = cms_walk.walk_in_chunks(torch.zeros((4, 2048), dtype=torch.int32),
                                           torch.from_numpy(_ledger(32)), torch.from_numpy(ids))
    assert walked.sequential_chunks < 0.05 * (ids.size // cms_walk.CHUNK)
    assert walked.evictions < walked.sequential_chunks * cms_walk.CHUNK
    assert walked.raises > ids.size // 4


@pytest.mark.parametrize("step", [1, cms_walk.CHUNK, cms_walk.STEP, 1000])
@pytest.mark.parametrize("name", ["zipf", "wrap_near_2p31", "raise_at_the_minimum_before_a_candidate", "k=33"])
def test_the_walk_does_not_depend_on_its_step(name, step):
    """Raises commute between evictions, so the ledger and the raise and
    eviction counts are the same whatever the step the raises are batched
    over; the kernel takes 512 items a step for k <= 32 and 32 beyond."""
    counts, ledger, ids = _walk_case(name)
    args = (torch.from_numpy(counts), torch.from_numpy(ledger), torch.from_numpy(ids))
    want_counts, want_ledger = cms_walk.cms_walk_reference(*args)
    got_counts, got_ledger, walked = cms_walk.walk_in_chunks(*args, step=step)
    assert torch.equal(got_counts, want_counts) and torch.equal(got_ledger, want_ledger)
    assert (walked.raises, walked.evictions) == _sequential_counts(counts, ledger, ids)
    assert cms_walk.walk_step(ledger.shape[0]) == (cms_walk.STEP if ledger.shape[0] <= 32 else cms_walk.CHUNK)


@pytest.mark.parametrize("n,cells", [(1, 8192), (1024, 8192), (1025, 8192), (2**17, 8192), (2**22, 8192),
                                     (2**31 - 1, 1), (4096, 2**23)])
def test_segments_cover_the_batch_within_the_scratch_budget(n, cells):
    segs = cms_walk.segments(n, cells)
    per = -(-n // segs)
    assert 1 <= segs <= min(n, cms_walk.MAX_SEGMENTS) and (segs - 1) * per < n <= segs * per
    assert segs * cells <= max(cms_walk.SEGMENT_CELLS, cells)


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
        (lambda: cms_walk.cms_walk_cuda(_meta(4, 64), _meta(8, 2), _meta(5), _meta(1, dtype=torch.int64)), ValueError,
         "3 contiguous int64"),
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
