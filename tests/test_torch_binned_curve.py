"""The port's threshold-count kernel plane against the JAX package's, on the CPU.

The same seeded numpy inputs go through ``metrics_tpu.kernels.binned_curve``
(the jnp comparison reference, and the Pallas kernel in interpret mode) and
through ``metrics_tpu_torch.kernels.binned_curve`` (the plain version, the
plain form of the CUDA kernel's sorted-threshold route, the CUDA wrapper,
which takes the plain version on CPU tensors, and the registry entry). Tolerances: with 0/1 weights every count is an integer, so the
results must be equal (``torch.equal`` / ``assert_array_equal``); with float
weights sums are taken in another order, so ``rtol=1e-5, atol=1e-4``. The
JAX package has no column axis: a ``(M, C)`` call is held column by column
against JAX's 1-D functions. The CUDA kernel itself runs only on the GPU
(``chip_smoke.py`` Phase G); here its wrapper is held to its checks on
``meta`` tensors.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.kernels import binned_curve as jax_bc
from metrics_tpu_torch import obs
from metrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg
from metrics_tpu_torch.kernels import binned_curve, registry
from metrics_tpu_torch.obs import instrument

FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one thread per test beside the suite's parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scores(rng, shape, thr):
    """Uniform scores with the edge values mixed in: NaN, +-inf, -0.0, 0, 1, and
    scores exactly equal to a threshold."""
    p = rng.uniform(size=shape).astype(np.float32)
    flat = p.reshape(-1)
    n = flat.size
    specials = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0], np.float32)
    k = min(n, 12)
    idx = rng.choice(n, size=k, replace=False)
    flat[idx[: k // 2]] = specials[rng.integers(0, specials.size, k // 2)]
    flat[idx[k // 2:]] = thr[rng.integers(0, thr.size, k - k // 2)]  # ties with a threshold
    return p


def _thresholds(rng, kind, t):
    if kind == "linspace":
        return np.array(jnp.linspace(0, 1, t, dtype=jnp.float32))
    if kind == "descending":
        return np.sort(rng.uniform(size=t).astype(np.float32))[::-1].copy()
    thr = rng.uniform(size=t).astype(np.float32)  # unsorted
    if kind == "specials":  # NaN, +-inf, -0.0 beside +0.0, and a duplicate, among unsorted values
        specials = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, np.nan], np.float32)[:t]
        thr[rng.choice(t, size=specials.size, replace=False)] = specials
        if t > 8:
            thr[7] = thr[8]
        return thr
    if t > 2:
        thr[1] = thr[0]  # a duplicate
    return thr


def _jax_counts(fn, p, tw, w, thr, **kw):
    """JAX's 1-D counts, column by column for 2-D inputs: (T,) or (T, C) float32."""
    if p.ndim == 1:
        tp, fp = fn(jnp.asarray(p), jnp.asarray(tw), jnp.asarray(w), jnp.asarray(thr), **kw)
        return np.asarray(tp), np.asarray(fp)
    cols = [fn(jnp.asarray(p[:, c]), jnp.asarray(tw[:, c]), jnp.asarray(w if w.ndim == 1 else w[:, c]),
               jnp.asarray(thr), **kw) for c in range(p.shape[1])]
    return np.stack([np.asarray(tp) for tp, _ in cols], 1), np.stack([np.asarray(fp) for _, fp in cols], 1)


def _port_paths():
    return (
        ("reference", binned_curve.reference_counts),
        ("sorted route", binned_curve.sorted_route_counts),
        ("cuda wrapper", binned_curve.binned_curve_counts_cuda),
        ("registry", binned_curve.binned_curve_counts),
    )


# (N, C, T, thresholds, per-row w, Pallas): N = 1 and N not a multiple of any
# tile (the kernel's 1024-row tile, the Pallas 8192-sample step); T = 1 and
# T = 1024 (one full threshold chunk of the kernel); C = 1 and C = 10
CASES_01 = [
    (1, 1, 5, "linspace", False, True),
    (8193, 1, 200, "linspace", False, True),
    (3001, 1, 1, "linspace", False, True),
    (2500, 1, 1024, "linspace", False, True),
    (1500, 1, 37, "unsorted", False, True),
    (2049, 10, 100, "linspace", False, False),
    (777, 10, 33, "unsorted", True, False),
    (1, 10, 7, "linspace", True, False),
    (2000, 1, 12, "specials", False, True),
    (999, 4, 9, "specials", True, False),
    (300, 5, 1, "specials", True, False),
    (1500, 1, 64, "descending", False, True),
    (640, 3, 20, "descending", False, False),
]


@pytest.mark.parametrize("n,c,t,kind,per_row,pallas", CASES_01)
def test_plain_version_equals_jax_on_01_weights(n, c, t, kind, per_row, pallas):
    rng = np.random.default_rng(n * 31 + c * 7 + t)
    thr = _thresholds(rng, kind, t)
    shape = (n,) if c == 1 else (n, c)
    p = _scores(rng, shape, thr)
    w = rng.integers(0, 2, shape[:1] if per_row else shape).astype(np.float32)
    y = rng.integers(0, 2, shape).astype(np.float32)
    tw = y * (w[:, None] if per_row else w)
    want = _jax_counts(jax_bc.reference_counts, p, tw, w, thr)
    if pallas:
        got = _jax_counts(jax_bc.pallas_counts, p, tw, w, thr, interpret=True)
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g, wnt, err_msg="Pallas interpret vs jnp reference")
    args = [torch.from_numpy(a) for a in (p, tw, w, thr)]
    for name, fn in _port_paths():
        tp, fp = fn(*args)
        assert tp.dtype == fp.dtype == torch.float32 and tuple(tp.shape) == (t,) + shape[1:], name
        np.testing.assert_array_equal(tp.numpy(), want[0], err_msg=name)
        np.testing.assert_array_equal(fp.numpy(), want[1], err_msg=name)


@pytest.mark.parametrize("n,c", [(3000, 1), (4097, 3)])
def test_plain_version_allclose_to_jax_on_float_weights(n, c):
    """The case of ``tests/kernels/test_bit_identity.py``: the weight enters
    twice (``w * tw = w**2 * y``), so Σ w·y would be far off."""
    rng = np.random.default_rng(12 + c)
    thr = np.array(jnp.linspace(0, 1, 50, dtype=jnp.float32))
    shape = (n,) if c == 1 else (n, c)
    p = _scores(rng, shape, thr)
    w = rng.uniform(0.1, 2.0, shape).astype(np.float32)
    tw = rng.integers(0, 2, shape).astype(np.float32) * w
    want = _jax_counts(jax_bc.reference_counts, p, tw, w, thr)
    pallas = _jax_counts(jax_bc.pallas_counts, p, tw, w, thr, interpret=True)
    tp, fp = binned_curve.reference_counts(*[torch.from_numpy(a) for a in (p, tw, w, thr)])
    for got, wnt, pal in ((tp, want[0], pallas[0]), (fp, want[1], pallas[1])):
        np.testing.assert_allclose(got.numpy(), wnt, rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
        np.testing.assert_allclose(got.numpy(), pal, rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
    for got, wnt in zip(binned_curve.sorted_route_counts(*[torch.from_numpy(a) for a in (p, tw, w, thr)]), want):
        np.testing.assert_allclose(got.numpy(), wnt, rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
    sum_wy = (w * (tw != 0) * (p >= thr[0])).sum(0)  # what a Σ w·y kernel would give at thr[0]
    assert not np.allclose(tp[0].numpy(), sum_wy, rtol=1e-3)


@pytest.mark.parametrize("route", ["reference_counts", "sorted_route_counts"])
def test_nan_and_infinite_scores_pass_no_threshold_but_minus_inf(route):
    p = torch.tensor([np.nan, np.inf, -np.inf, -0.0, 0.5])
    ones = torch.ones(5)
    thr = torch.tensor([-np.inf, 0.0, 0.5, 1.0, np.inf, np.nan])
    tp, fp = getattr(binned_curve, route)(p, ones, ones, thr)
    # -inf passes only thr = -inf; -0.0 >= 0.0; +inf passes every threshold but NaN
    np.testing.assert_array_equal(tp.numpy(), [4, 3, 2, 1, 1, 0])
    np.testing.assert_array_equal(fp.numpy(), np.zeros(6))


def test_empty_batch_gives_zeros():
    thr = torch.linspace(0, 1, 4)
    empty = torch.zeros(0)
    tp, fp = binned_curve.binned_curve_counts(empty, empty, empty, thr)
    assert tp.shape == fp.shape == (4,) and not tp.any() and not fp.any()
    tp, fp = binned_curve.reference_counts(torch.zeros(0, 3), torch.zeros(0, 3), empty, thr)
    assert tp.shape == (4, 3) and not tp.any()


def test_thresholds_int_equal_jnp_linspace_bit_for_bit_for_every_t():
    """Every T in 2..1024, compiled as one jit of 1023 ``jnp.linspace`` calls (one
    compile instead of 1023); four T are also held against a lone call."""
    ts = range(2, 1025)
    every = jax.jit(lambda: tuple(jnp.linspace(0, 1, t, dtype=jnp.float32) for t in ts))()
    for t in (2, 100, 200, 1000):
        np.testing.assert_array_equal(np.asarray(every[t - 2]), np.asarray(jnp.linspace(0, 1, t, dtype=jnp.float32)))
    for t, want in zip(ts, every):
        got = _adjust_threshold_arg(t)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), np.asarray(want)), f"T = {t}"
    # torch.linspace itself is not bit-identical (the trap the formula avoids)
    assert not np.array_equal(torch.linspace(0, 1, 1000).numpy(), np.asarray(every[1000 - 2]))


def test_registry_entry_dispatches_once_per_call_on_the_cpu():
    entry = registry.get("binned_curve_counts")
    assert entry.reference is binned_curve.reference_counts
    assert entry.optimized is binned_curve.binned_curve_counts_cuda
    assert {"binned_curve_counts", "pair_count_cuda", "ddsketch_hist_add"} <= set(registry.names())
    x = torch.rand(64)
    thr = torch.linspace(0, 1, 9)
    assert registry.selected("binned_curve_counts", x, x, x, thr) == "reference"
    before = binned_curve.launches
    obs.enable()
    try:
        instrument.KERNEL_DISPATCHES.clear()
        binned_curve.binned_curve_counts(x, x, x, thr)
        binned_curve.binned_curve_counts(x, x, x, thr)
        assert instrument.KERNEL_DISPATCHES.value(kernel="binned_curve_counts", impl="reference") == 2
        assert instrument.KERNEL_DISPATCHES.value(kernel="binned_curve_counts", impl="optimized") == 0
    finally:
        obs.disable()
    assert binned_curve.launches == before  # the CPU never launches


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize(
    "args,exc,match",
    [
        ((_meta(8), _meta(8), _meta(8), _meta(4)), ValueError, "CUDA device or the CPU"),
        ((_meta(8, 3), _meta(8, 3), _meta(8), _meta(4)), ValueError, "CUDA device or the CPU"),
        ((_meta(8), _meta(8), _meta(8), _meta(4, dtype=torch.float64)), TypeError, "float32"),
        ((_meta(8, dtype=torch.float16), _meta(8), _meta(8), _meta(4)), TypeError, "float32"),
        ((_meta(8, 2).T, _meta(2, 8), _meta(2, 8), _meta(4)), ValueError, "contiguous"),
        ((_meta(8), _meta(7), _meta(8), _meta(4)), ValueError, "differ"),
        ((_meta(8, 3), _meta(8, 3), _meta(3), _meta(4)), ValueError, "per row"),
        ((_meta(8), _meta(8), _meta(8), _meta(2, 2)), ValueError, r"\(T,\)"),
        ((_meta(8), _meta(8), _meta(8), _meta(0)), ValueError, r"\(T,\)"),
        ((_meta(2, 2, 2), _meta(2, 2, 2), _meta(2, 2, 2), _meta(4)), ValueError, r"\(M,\) or \(M, C\)"),
    ],
)
def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take(args, exc, match):
    with pytest.raises(exc, match=match):
        binned_curve.binned_curve_counts_cuda(*args)


def test_registry_raises_for_an_ineligible_non_cpu_call():
    with pytest.raises(ValueError, match="not eligible"):
        registry.dispatch("binned_curve_counts", _meta(8, 2, 2), _meta(8, 2, 2), _meta(8), _meta(4))
    with pytest.raises(ValueError, match="not eligible"):
        registry.dispatch("binned_curve_counts", _meta(8, 70000), _meta(8, 70000), _meta(8), _meta(4))


def test_kernel_source_exports_what_the_wrapper_binds():
    src = (Path(binned_curve.__file__).parent.parent / "csrc" / f"{binned_curve.KERNEL_NAME}.cu").read_text()
    for symbol in ("int binned_curve_launch(", "long long binned_curve_scratch_words(",
                   "int binned_curve_uses_sorted(", "binned_curve_error_string("):
        assert symbol in src
    # float sums run in a fixed order, never by atomics: the atomicAdds are the int counts of the
    # 0/1 contributions
    assert re.findall(r"atomicAdd\(([^,]+),", src) == ["&col_counts[k].x", "&col_counts[k].y"]


@pytest.mark.parametrize("strided", ["thresholds", "preds"])
def test_registry_entry_makes_strided_inputs_contiguous_for_the_kernel(strided):
    """A user's sliced thresholds or transposed scores work on the GPU as on the
    CPU: the wrapper refuses them, the registry entry passes them on contiguous,
    so on ``meta`` tensors the call gets as far as the device check."""
    if strided == "thresholds":
        p, thr = _meta(8, 3), _adjust_threshold_arg(torch.linspace(0, 1, 400, device="meta")[::2], device="meta")
    else:
        p, thr = _meta(3, 8).T, _meta(4)
    assert not (p.is_contiguous() and thr.is_contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        binned_curve.binned_curve_counts_cuda(p, _meta(8, 3), _meta(8), thr)
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        binned_curve.binned_curve_counts(p, _meta(8, 3), _meta(8), thr)


SORTED_SMEM_BUDGET = 230000  # kSortedSmemBudget of csrc/binned_curve.cu


def _hist_units(n_cols):
    """Float histograms of one column a block of the sorted route keeps (``hist_units`` of the kernel)."""
    if n_cols <= 8:
        return 8 // n_cols * n_cols
    warps = min(n_cols, 16)
    return warps * -(-n_cols // warps)


def _uses_sorted_route(n_cols, n_thr):
    """The kernel's route rule (``uses_sorted``), for the CPU: the sorted-threshold
    route while a block's int counts (8 bytes a bucket of each column), its warps'
    float histograms (12 bytes a bucket, 4 a histogram) and the thresholds with
    their indices, padded to a power of two, fit ``kSortedSmemBudget`` bytes."""
    if n_thr > 2**20:
        return False
    pad = 1 << max(n_thr - 1, 0).bit_length()
    units = _hist_units(n_cols)
    return n_cols * 8 * (n_thr + 1) + units * (12 * (n_thr + 1) + 4) + pad * 8 <= SORTED_SMEM_BUDGET


def _sorted_route_max_thresholds(n_cols):
    """The largest ``T`` that takes the sorted-threshold route for ``C`` columns."""
    return max(t for t in range(1, 4096) if _uses_sorted_route(n_cols, t))


def test_route_crossover_matches_the_kernel_source():
    """The test's mirror of the kernel's route rule reads the constants and the
    shared-memory layout the kernel source states: the sorted-threshold route
    while a block's tables fit ``kSortedSmemBudget`` bytes, the comparison
    route above."""
    src = (Path(binned_curve.__file__).parent.parent / "csrc" / f"{binned_curve.KERNEL_NAME}.cu").read_text()
    assert f"constexpr long long kSortedSmemBudget = {SORTED_SMEM_BUDGET};" in src
    assert "constexpr int kMaxHistWarps = 16;" in src
    assert "constexpr int kFewColWarps = 8;" in src
    assert "(long long)n_cols * buckets * sizeof(int2)" in src  # 8 bytes of int counts a bucket of each column
    assert "(long long)hist_units(n_cols) * (buckets * (sizeof(float2) + sizeof(int)) + sizeof(int))" in src
    for c, t_max in ((1, 2048), (3, 2053), (10, 1066), (16, 691), (33, 267)):
        assert _sorted_route_max_thresholds(c) == t_max
        assert _uses_sorted_route(c, t_max) and not _uses_sorted_route(c, t_max + 1)
    assert _uses_sorted_route(10, 200) and _uses_sorted_route(1, 1024)
    assert not _uses_sorted_route(3, 2**20 + 1)


@pytest.mark.parametrize("n_cols,side", [(1, 0), (1, 1), (16, 0), (16, 1)])
def test_sorted_route_equals_the_plain_version_at_the_crossover(n_cols, side):
    """Both sides of the route crossover, unsorted thresholds with the special
    values: the sorted route's plain form equals the comparison form bit for bit."""
    n_thr = _sorted_route_max_thresholds(n_cols) + side
    rng = np.random.default_rng(n_cols * 7 + n_thr)
    thr = _thresholds(rng, "specials", n_thr)
    shape = (600,) if n_cols == 1 else (600, n_cols)
    p = _scores(rng, shape, thr)
    w = rng.integers(0, 2, shape).astype(np.float32)
    tw = rng.integers(0, 2, shape).astype(np.float32) * w
    args = [torch.from_numpy(a) for a in (p, tw, w, thr)]
    for got, want in zip(binned_curve.sorted_route_counts(*args), binned_curve.reference_counts(*args)):
        assert torch.equal(got, want)
