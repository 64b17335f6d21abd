"""The port's pair count against the JAX package's, on the CPU.

The same numpy inputs go through ``metrics_tpu.kernels.confmat`` (the
bincount reference, and the Pallas kernel in interpret mode) and through
``metrics_tpu_torch.kernels.confmat``. Tolerance: exact equality, int32.
The CUDA kernel itself runs only on the GPU (``chip_smoke.py``); here its
wrapper is held to taking the plain version on CPU tensors and raising on any
other device.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.kernels import confmat as jax_confmat
from metrics_tpu_torch import obs
from metrics_tpu_torch.kernels import _build, confmat, registry
from metrics_tpu_torch.obs import instrument


def _both(r, c, mask):
    jr, jc = jnp.asarray(r), jnp.asarray(c)
    jm = None if mask is None else jnp.asarray(mask)
    tr, tc = torch.from_numpy(r), torch.from_numpy(c)
    tm = None if mask is None else torch.from_numpy(mask)
    return (jr, jc, jm), (tr, tc, tm)


def _assert_port_matches(want, tr, tc, rows, cols, tm):
    want = np.asarray(want)
    for fn in (confmat.pair_count, confmat.pair_count_bincount, confmat.pair_count_matmul, confmat.pair_count_cuda):
        got = fn(tr, tc, rows, cols, tm)
        assert got.dtype == torch.int32, fn.__name__
        np.testing.assert_array_equal(got.numpy(), want, err_msg=fn.__name__)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint8])
def test_pair_count_matches_jax(seed, dtype):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 3) * 4096 + rng.integers(0, 513))  # ragged lengths
    rows = int(rng.integers(2, 150))
    cols = int(rng.integers(2, 150))
    r = rng.integers(0, rows, n).astype(dtype)
    c = rng.integers(0, cols, n).astype(dtype)
    mask = rng.integers(0, 2, n).astype(bool) if seed % 2 else None
    (jr, jc, jm), (tr, tc, tm) = _both(r, c, mask)
    want = jax_confmat.pair_count_bincount(jr, jc, rows, cols, jm)
    via_pallas = jax_confmat.pair_count_fused(jr, jc, rows, cols, jm, interpret=True)
    np.testing.assert_array_equal(np.asarray(via_pallas), np.asarray(want))
    _assert_port_matches(want, tr, tc, rows, cols, tm)


@pytest.mark.parametrize("masked", [False, True])
def test_pair_count_drops_out_of_range_and_negative_pairs(masked):
    rng = np.random.default_rng(11)
    n = 4608
    r = rng.integers(-3, 12, n).astype(np.int32)  # out of range on both sides
    c = rng.integers(-3, 12, n).astype(np.int32)
    mask = rng.integers(0, 2, n).astype(bool) if masked else None
    (jr, jc, jm), (tr, tc, tm) = _both(r, c, mask)
    want = jax_confmat.pair_count_bincount(jr, jc, 10, 10, jm)
    np.testing.assert_array_equal(
        np.asarray(jax_confmat.pair_count_fused(jr, jc, 10, 10, jm, interpret=True)), np.asarray(want)
    )
    _assert_port_matches(want, tr, tc, 10, 10, tm)


def test_pair_count_rectangular_7x23_ragged():
    rng = np.random.default_rng(5)
    n = 4097
    r = rng.integers(0, 7, n).astype(np.int32)
    c = rng.integers(0, 23, n).astype(np.int32)
    (jr, jc, _), (tr, tc, _) = _both(r, c, None)
    want = jax_confmat.pair_count_bincount(jr, jc, 7, 23)
    assert want.shape == (7, 23)
    np.testing.assert_array_equal(np.asarray(jax_confmat.pair_count_fused(jr, jc, 7, 23, interpret=True)), np.asarray(want))
    _assert_port_matches(want, tr, tc, 7, 23, None)


def test_pair_count_empty_input_is_zeros():
    r = np.zeros(0, np.int32)
    (jr, jc, _), (tr, tc, _) = _both(r, r.copy(), None)
    want = jax_confmat.pair_count_bincount(jr, jc, 4, 6)
    assert not np.asarray(want).any()
    _assert_port_matches(want, tr, tc, 4, 6, None)


def test_float_mask_counts_like_a_bool_mask():
    rng = np.random.default_rng(3)
    r = rng.integers(0, 9, 700).astype(np.int64)
    c = rng.integers(0, 9, 700).astype(np.int64)
    mask = rng.integers(0, 2, 700).astype(bool)
    tr, tc = torch.from_numpy(r), torch.from_numpy(c)
    want = confmat.pair_count_bincount(tr, tc, 9, 9, torch.from_numpy(mask))
    got = confmat.pair_count(tr, tc, 9, 9, torch.from_numpy(mask.astype(np.float32)))
    assert torch.equal(got, want)


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing():
    r = torch.tensor([0, 1, 2, 2], dtype=torch.int32)
    c = torch.tensor([0, 1, 1, 2], dtype=torch.int32)
    assert registry.selected("pair_count_cuda", r, c, 3, 3) == "reference"
    before = confmat.launches
    obs.enable()
    try:
        instrument.KERNEL_DISPATCHES.clear()
        out = confmat.pair_count(r, c, 3, 3)
        dispatched = instrument.KERNEL_DISPATCHES.value(kernel="pair_count_cuda", impl="reference")
    finally:
        obs.disable()
    assert confmat.launches == before
    assert dispatched == 1
    assert torch.equal(out, torch.tensor([[1, 0, 0], [0, 1, 0], [0, 1, 1]], dtype=torch.int32))


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Off the CPU the registry selects the kernel, whose wrapper launches on
    CUDA and raises on any other device: no call falls back to the plain version."""
    r = torch.zeros(8, dtype=torch.int32, device="meta")
    assert registry.selected("pair_count_cuda", r, r, 3, 3) == "optimized"
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        confmat.pair_count(r, r, 3, 3)


def test_registry_raises_for_an_ineligible_non_cpu_call():
    r = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="not eligible"):
        registry.dispatch("pair_count_cuda", r, r, 2**16, 2**16)  # R*C >= 2**31


def test_registry_entry_and_names():
    entry = registry.get("pair_count_cuda")
    assert entry.reference is confmat.pair_count_bincount
    assert entry.optimized is confmat.pair_count_cuda
    assert "pair_count_cuda" in registry.names()


def test_kernel_library_is_keyed_by_source_hash(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    (src / "k.cu").write_text("// v2\n")
    assert _build.library_path("k") != first
    assert first.parent == tmp_path / "build" and first.name.startswith("libk-")


def test_build_without_nvcc_raises_and_leaves_no_file(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("pair_count")
    assert not (tmp_path / "build").exists()


# ------------------------------------------------ ignore_index, int64 labels, the stat-score route


def _jax_table(r, c, rows, cols, ignore_index, mask=None):
    """The JAX package's confusion-matrix semantics on its own pair counts: the
    labels as it sees them (int32), ignored rows masked out and zeroed."""
    jr, jc = jnp.asarray(r), jnp.asarray(c)
    keep = jnp.ones(jr.shape, bool) if ignore_index is None else jr != ignore_index
    if mask is not None:
        keep = keep & jnp.asarray(mask)
    jr = jnp.where(keep, jr, 0)
    want = jax_confmat.pair_count_bincount(jr, jc, rows, cols, keep)
    np.testing.assert_array_equal(
        np.asarray(jax_confmat.pair_count_fused(jr, jc, rows, cols, keep, interpret=True)), np.asarray(want)
    )
    return np.asarray(want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("ignore_index", [None, 4, -1, 30])
def test_pair_count_ignore_index_matches_jax(ignore_index, dtype, masked):
    rng = np.random.default_rng(100 + (ignore_index or 0) + 7 * masked)
    n, rows, cols = 3001, 9, 13
    r = rng.integers(-2, rows + 2, n)
    if ignore_index is not None:
        r = np.where(rng.random(n) < 0.2, ignore_index, r)
    r, c = r.astype(dtype), rng.integers(-2, cols + 2, n).astype(dtype)
    mask = rng.integers(0, 2, n).astype(bool) if masked else None
    want = _jax_table(r, c, rows, cols, ignore_index, mask)
    tr, tc = torch.from_numpy(r), torch.from_numpy(c)
    tm = None if mask is None else torch.from_numpy(mask)
    for fn in (confmat.pair_count, confmat.pair_count_bincount, confmat.pair_count_matmul, confmat.pair_count_cuda):
        got = fn(tr, tc, rows, cols, tm, ignore_index)
        assert got.dtype == torch.int32, fn.__name__
        np.testing.assert_array_equal(got.numpy(), want, err_msg=fn.__name__)


@pytest.mark.parametrize("ignore_index", [None, 3])
def test_int64_labels_count_by_their_low_word_like_jax(ignore_index):
    rng = np.random.default_rng(5 + (ignore_index or 0))
    n = 2049
    r = rng.integers(0, 6, n) + rng.choice([0, 2**32, 2**31, -(2**32), 2**40], n)
    c = rng.integers(0, 6, n) + rng.choice([0, 2**32, 2**33 + 2**31], n)
    want = _jax_table(r, c, 6, 6, ignore_index)
    got = confmat.pair_count(torch.from_numpy(r), torch.from_numpy(c), 6, 6, ignore_index=ignore_index)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ignore_index_is_compared_after_the_truncation():
    """The target 2**32 + 3 is class 3 to the JAX package (x64 off), so
    ``ignore_index=3`` drops it there; comparing the int64 value first would
    keep it. The port drops it on both routes."""
    target = np.array([2**32 + 3, 2, 2**32 + 3], np.int64)
    preds = np.array([3, 2, 1], np.int64)
    want = _jax_table(target, preds, 5, 5, 3)
    assert want.sum() == 1 and want[2, 2] == 1
    tt, tp = torch.from_numpy(target), torch.from_numpy(preds)
    np.testing.assert_array_equal(confmat.pair_count(tt, tp, 5, 5, ignore_index=3).numpy(), want)
    tp_, fp_, tn_, fn_ = confmat.stat_scores(tt, tp, 5, 3)
    assert tp_.tolist() == [0, 0, 1, 0, 0] and fp_.tolist() == fn_.tolist() == [0] * 5
    assert tn_.tolist() == [1, 1, 0, 1, 1]


def test_stat_scores_cpu_tensor_takes_the_plain_version_and_launches_nothing():
    t = torch.tensor([0, 1, 2, 2], dtype=torch.int64)
    p = torch.tensor([0, 1, 1, 2], dtype=torch.int64)
    assert registry.selected("stat_scores_cuda", t, p, 3) == "reference"
    before = (confmat.launches, confmat.stat_score_launches)
    obs.enable()
    try:
        instrument.KERNEL_DISPATCHES.clear()
        tp, fp, tn, fn = confmat.stat_scores(t, p, 3)
        dispatched = instrument.KERNEL_DISPATCHES.value(kernel="stat_scores_cuda", impl="reference")
    finally:
        obs.disable()
    assert (confmat.launches, confmat.stat_score_launches) == before
    assert dispatched == 1
    assert [x.tolist() for x in (tp, fp, tn, fn)] == [[1, 1, 1], [0, 1, 0], [3, 2, 2], [0, 0, 1]]
    assert all(x.dtype == torch.int32 for x in (tp, fp, tn, fn))


def test_stat_scores_non_cpu_tensor_never_takes_the_plain_version():
    t = torch.zeros(8, dtype=torch.int64, device="meta")
    assert registry.selected("stat_scores_cuda", t, t, 3) == "optimized"
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        confmat.stat_scores(t, t, 3)
    with pytest.raises(ValueError, match="not eligible"):
        registry.dispatch("stat_scores_cuda", t, t, 2**29)  # 4 * C + 2 >= 2**31


def test_stat_scores_registry_entry():
    entry = registry.get("stat_scores_cuda")
    assert entry.reference is confmat.stat_scores_bincount
    assert entry.optimized is confmat.stat_scores_cuda


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
            "long long": ctypes.c_longlong, "const char*": ctypes.c_char_p}


def test_kernel_source_exports_what_the_wrapper_binds():
    """Every C function the wrapper binds exists in ``csrc/pair_count.cu`` with
    the parameter and return types of ``confmat._SIGNATURES``: a mismatch would
    show only on the card."""
    src = (Path(confmat.__file__).parent.parent / "csrc" / f"{confmat.KERNEL_NAME}.cu").read_text()
    exported = src[src.index('extern "C" {'):]
    for name, (argtypes, restype) in confmat._SIGNATURES.items():
        m = re.search(r"^(const char\*|int) " + name + r"\(([^)]*)\)", exported, re.M)
        assert m, name
        params = [re.sub(r"\s+", " ", p).strip().rsplit(" ", 1)[0] for p in m.group(2).split(",")]
        params = [p.replace(" *", "*") for p in params]
        assert [_C_TYPES[p] for p in params] == argtypes, name
        assert _C_TYPES[m.group(1)] is restype, name


@pytest.mark.parametrize("ignore_index", [2**31, -(2**31) - 1, 2**32 + 3, 2**40])
def test_ignore_index_outside_int32_raises_on_every_route(ignore_index):
    """Labels count as int32, so an ``ignore_index`` outside the int32 range
    has no meaning: the JAX package raises on it (x64 off), and every route of
    the port raises too, the plain versions and the kernel's argument check
    alike, so that the two can never disagree on it."""
    r = np.array([1, 2, 3], np.int64)
    with pytest.raises(OverflowError):
        jnp.asarray(r.astype(np.int32)) != ignore_index
    t = torch.from_numpy(r)
    for fn in (confmat.pair_count, confmat.pair_count_bincount, confmat.pair_count_matmul, confmat.pair_count_cuda):
        with pytest.raises(ValueError, match="int32 range"):
            fn(t, t, 5, 5, None, ignore_index)
    for fn in (confmat.stat_scores, confmat.stat_scores_bincount, confmat.stat_scores_cuda):
        with pytest.raises(ValueError, match="int32 range"):
            fn(t, t, 5, ignore_index)
    with pytest.raises(ValueError, match="int32 range"):
        confmat._ignore_args(ignore_index, "pair_count_cuda")


@pytest.mark.parametrize("ignore_index", [-(2**31), 2**31 - 1])
def test_ignore_index_at_the_int32_extremes_matches_jax(ignore_index):
    """The extremes are int32 values: a label whose low 32 bits equal them is
    dropped, as the JAX package drops it."""
    rng = np.random.default_rng(abs(ignore_index) % 97)
    n = 1001
    r = rng.integers(0, 6, n).astype(np.int64)
    r = np.where(rng.random(n) < 0.3, ignore_index, r)
    r = np.where(rng.random(n) < 0.3, r + 2**32, r)  # the same low word
    c = rng.integers(0, 6, n).astype(np.int64)
    want = _jax_table(r, c, 6, 6, ignore_index)
    tr, tc = torch.from_numpy(r), torch.from_numpy(c)
    np.testing.assert_array_equal(confmat.pair_count(tr, tc, 6, 6, ignore_index=ignore_index).numpy(), want)
    assert confmat._ignore_args(ignore_index, "pair_count_cuda") == (ignore_index, 1)
