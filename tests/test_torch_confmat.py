"""The port's pair count against the JAX package's, on the CPU.

The same numpy inputs go through ``metrics_tpu.kernels.confmat`` (the
bincount reference, and the Pallas kernel in interpret mode) and through
``metrics_tpu_torch.kernels.confmat``. Tolerance: exact equality, int32.
The CUDA kernel itself runs only on the GPU (``chip_smoke.py``); here its
wrapper is held to taking the plain version on CPU tensors and raising on any
other device.
"""

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
