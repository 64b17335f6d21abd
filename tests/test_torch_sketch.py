"""The port's sketch plane against the JAX package's, on the CPU.

The same seeded numpy inputs go through ``metrics_tpu.sketch`` and
``metrics_tpu_torch.sketch``: the hash and its helpers, the DDSketch,
HyperLogLog and count-min kernels, the three metric classes and their
functional twins, ``merge_states``, the accuracy contracts of
``tests/sketch/test_accuracy.py``, and JAX states carried into the port.

Tolerances: every int32 state (buckets, zero count, registers, count-min
table, heavy-hitter ledger) and every hash is exact. The DDSketch bucket of a
value is ``ceil(log|v| / log gamma)`` in float32; ``torch.log`` and
``jnp.log`` on the CPU agree on every value these tests draw, so the buckets
are demanded bit for bit too. Float outputs (quantile estimates through
``exp``, the HyperLogLog estimate through a float32 sum of up to 2**16 terms
in another order) agree within rtol 1e-6; the float32 min/max states are
exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.functional import sketch as jax_fsketch
from metrics_tpu.sketch import CardinalitySketch as JaxCardinality
from metrics_tpu.sketch import HeavyHittersSketch as JaxHeavyHitters
from metrics_tpu.sketch import QuantileSketch as JaxQuantile
from metrics_tpu.sketch import kernels as J
from metrics_tpu_torch.functional import approx_count_distinct, approx_heavy_hitters, approx_quantiles
from metrics_tpu_torch.kernels import cms_walk, scatter
from metrics_tpu_torch.sketch import CardinalitySketch, HeavyHittersSketch, QuantileSketch
from metrics_tpu_torch.sketch import kernels as T
from metrics_tpu_torch.utils.params_io import metric_state_from_jax

RTOL = 1e-6
GAMMA, LOG_GAMMA, OFFSET = J.ddsketch_params(0.01)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run beside the rest of the suite in parallel workers, some
    of which time a watchdog in fractions of a second: keep PyTorch's share of
    the CPU to one thread per test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return np.asarray(jax.device_get(x))


def _assert_state_equal(jax_state, torch_state, names=None):
    for name in names or jax_state:
        want, got = _np(jax_state[name]), torch_state[name]
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        assert got.dtype == want.dtype, f"{name}: {got.dtype} vs {want.dtype}"
        np.testing.assert_array_equal(got, want, err_msg=name)


# --------------------------------------------------------------------- hashing

HASH_INPUTS = {
    "int32": lambda rng: rng.integers(-(2**31), 2**31 - 1, 3000).astype(np.int32),
    "negative": lambda rng: -rng.integers(1, 2**31 - 1, 500).astype(np.int32),
    "bool": lambda rng: rng.integers(0, 2, 50).astype(bool),
    "float32": lambda rng: np.concatenate(
        [rng.standard_normal(2000), [np.nan, -0.0, 0.0, np.inf, -np.inf, 1.0, -1.0]]
    ).astype(np.float32),
    "int64": lambda rng: np.concatenate([rng.integers(-(2**40), 2**40, 500), [2**31, 2**32 + 5, -(2**31) - 1]]),
    "uint8": lambda rng: rng.integers(0, 256, 300).astype(np.uint8),
}


@pytest.mark.parametrize("kind", sorted(HASH_INPUTS))
@pytest.mark.parametrize("seed", [0, 7])
def test_hash32_bit_identical(kind, seed):
    x = HASH_INPUTS[kind](np.random.default_rng(seed))
    want = _np(J.hash32(jnp.asarray(x), seed=seed)).astype(np.int64)
    got = T.hash32(torch.from_numpy(x), seed=seed)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_hash32_of_a_python_scalar():
    assert int(T.hash32(12345)) == int(_np(J.hash32(12345)))
    assert int(T.hash32(2.5)) == int(_np(J.hash32(2.5)))


def test_mix32_py_and_row_seeds_are_the_jax_ones():
    for x in (0, 1, 2**31, 2**32 - 1, 0x9E3779B9):
        assert T._mix32_py(x) == J._mix32_py(x)
    np.testing.assert_array_equal(T._row_seeds(6), J._row_seeds(6))


def test_clz32_bit_identical():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.integers(0, 2**32, 5000, dtype=np.uint64), [0, 1, 2**31, 2**32 - 1, 2**16, 3]])
    want = _np(J._clz32(jnp.asarray(x.astype(np.uint32))))
    got = T._clz32(torch.from_numpy(x.astype(np.int64)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("depth,width", [(1, 64), (4, 2048), (5, 65536), (3, 1000)])
def test_cm_columns_bit_identical(depth, width):
    ids = np.random.default_rng(depth).integers(-1000, 10**7, 4000).astype(np.int32)
    want = _np(J._cm_columns(jnp.asarray(ids), depth, width))
    got = T._cm_columns(torch.from_numpy(ids), depth, width)
    assert got.dtype == torch.int32 and tuple(got.shape) == (4000, depth)
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------- DDSketch

DD_STREAMS = {
    "lognormal": lambda rng, n: rng.lognormal(0.0, 2.0, n),
    "uniform": lambda rng, n: rng.uniform(1.0, 1e4, n),
    "neg_lognormal": lambda rng, n: -rng.lognormal(1.0, 1.0, n),
    "mixed_sign": lambda rng, n: rng.standard_normal(n) * 100.0,
    "specials": lambda rng, n: np.concatenate(
        [rng.lognormal(0, 3, n), np.zeros(7), [np.nan, np.nan, np.inf, -np.inf, 1e-12, -1e-12, 1e30, -1e30]]
    ),
}


def _dd_jax_state():
    return (
        jnp.zeros(2048, jnp.int32), jnp.zeros(2048, jnp.int32), jnp.zeros((), jnp.int32),
        jnp.asarray(np.inf, jnp.float32), jnp.asarray(-np.inf, jnp.float32),
    )


def _dd_torch_state():
    return (
        torch.zeros(2048, dtype=torch.int32), torch.zeros(2048, dtype=torch.int32), torch.zeros((), dtype=torch.int32),
        torch.tensor(math.inf), torch.tensor(-math.inf),
    )


@pytest.mark.parametrize("stream", sorted(DD_STREAMS))
def test_ddsketch_update_and_quantiles(stream):
    rng = np.random.default_rng(len(stream))
    batches = [DD_STREAMS[stream](rng, 5000).astype(np.float32) for _ in range(2)]
    js, ts = _dd_jax_state(), _dd_torch_state()
    for b in batches:
        js = J.ddsketch_update(*js, jnp.asarray(b), log_gamma=LOG_GAMMA, offset=OFFSET)
        ts = T.ddsketch_update(*ts, torch.from_numpy(b), log_gamma=LOG_GAMMA, offset=OFFSET)
    for want, got in zip(js, ts):
        assert got.dtype == {np.int32: torch.int32, np.float32: torch.float32}[_np(want).dtype.type]
        np.testing.assert_array_equal(got.numpy(), _np(want))
    qs = (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0)
    want = _np(J.ddsketch_quantiles(*js, qs, gamma=GAMMA, offset=OFFSET))
    got = T.ddsketch_quantiles(*ts, qs, gamma=GAMMA, offset=OFFSET)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


def test_ddsketch_buckets_match_on_two_million_values():
    """The float32 bucket index agrees value for value (no edge ties here)."""
    rng = np.random.default_rng(11)
    v = np.concatenate([rng.lognormal(0, 4, 10**6), rng.uniform(1e-6, 1e6, 10**6)]).astype(np.float32)
    absv = jnp.abs(jnp.asarray(v))
    want = jnp.ceil(jnp.log(absv) * jnp.float32(1.0 / LOG_GAMMA)).astype(jnp.int32) + OFFSET
    got = T.ddsketch_buckets(torch.from_numpy(v), 2048, log_gamma=LOG_GAMMA, offset=OFFSET)
    np.testing.assert_array_equal(got.numpy(), np.clip(_np(want), 0, 2047))


def test_ddsketch_empty_batch_and_empty_sketch():
    ts = _dd_torch_state()
    out = T.ddsketch_update(*ts, torch.zeros(0), log_gamma=LOG_GAMMA, offset=OFFSET)
    assert all(a is b for a, b in zip(out, ts))
    got = T.ddsketch_quantiles(*ts, (0.0, 0.5, 1.0), gamma=GAMMA, offset=OFFSET)
    assert torch.isnan(got).all()
    assert np.isnan(_np(J.ddsketch_quantiles(*_dd_jax_state(), (0.5,), gamma=GAMMA, offset=OFFSET))).all()


def test_ddsketch_inf_goes_to_the_top_bucket_and_nan_nowhere():
    ts = T.ddsketch_update(*_dd_torch_state(), torch.tensor([math.inf, -math.inf, math.nan, 0.0]),
                           log_gamma=LOG_GAMMA, offset=OFFSET)
    pos, neg, zero, vmin, vmax = ts
    assert pos.sum() == 1 and pos[-1] == 1 and neg.sum() == 1 and neg[-1] == 1
    assert int(zero) == 1 and float(vmin) == -math.inf and float(vmax) == math.inf


# --------------------------------------------------------------------- HyperLogLog


@pytest.mark.parametrize("p", [4, 10, 12, 16])
def test_hll_update_and_estimate(p):
    rng = np.random.default_rng(p)
    ids = (rng.zipf(1.1, 20000) % 10**7).astype(np.int32)
    floats = rng.standard_normal(3000).astype(np.float32)  # hashed by their float32 bits
    want = J.hll_update(jnp.zeros(1 << p, jnp.int32), jnp.asarray(ids), p=p)
    want = J.hll_update(want, jnp.asarray(floats), p=p)
    got = T.hll_update(torch.zeros(1 << p, dtype=torch.int32), torch.from_numpy(ids), p=p)
    got = T.hll_update(got, torch.from_numpy(floats), p=p)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _np(want))
    np.testing.assert_allclose(float(T.hll_estimate(got)), float(_np(J.hll_estimate(want))), rtol=RTOL)


def test_hll_empty_batch_returns_the_registers():
    r = torch.zeros(16, dtype=torch.int32)
    assert T.hll_update(r, torch.zeros(0, dtype=torch.int32), p=4) is r


# ----------------------------------------------------------- count-min + top-k


@pytest.mark.parametrize("depth,width", [(4, 2048), (3, 64)])
def test_cms_table_update_and_query(depth, width):
    rng = np.random.default_rng(width)
    ids = (rng.zipf(1.1, 20000) % 10**7).astype(np.int32)
    ids[::50] = -3  # invalid ids count nowhere
    want = J.cms_table_update(jnp.zeros((depth, width), jnp.int32), jnp.asarray(ids))
    got = T.cms_table_update(torch.zeros((depth, width), dtype=torch.int32), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    keys = np.concatenate([ids[:300], [-1, 0, 5]]).astype(np.int32)
    np.testing.assert_array_equal(T.cms_query(got, torch.from_numpy(keys)).numpy(), _np(J.cms_query(want, jnp.asarray(keys))))
    assert int(T.cms_query(got, 7)) == int(_np(J.cms_query(want, 7)))


def _empty_ledger(k):
    return np.stack([np.full(k, -1, np.int32), np.zeros(k, np.int32)], axis=1)


# (the default 32 x 4 x 2048 sketch is held against the JAX twin below;
# each eager JAX ledger scan compiles anew, so the calls here are few)
@pytest.mark.parametrize("k,depth,width,n_ids", [(8, 3, 64, 200)])
def test_cms_update_hh_rank_and_topk_merge(k, depth, width, n_ids):
    rng = np.random.default_rng(k)
    a = (rng.zipf(1.1, 700) % n_ids).astype(np.int32)
    b = (rng.zipf(1.3, 700) % n_ids).astype(np.int32)
    a[::37] = -2
    zeros = np.zeros((depth, width), np.int32)
    js, ts = {}, {}
    for name, batch in (("a", a), ("b", b)):
        js[name] = J.cms_update(jnp.asarray(zeros), jnp.asarray(_empty_ledger(k)), jnp.asarray(batch))
        ts[name] = T.cms_update(torch.from_numpy(zeros), torch.from_numpy(_empty_ledger(k)), torch.from_numpy(batch))
        for want, got in zip(js[name], ts[name]):
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), _np(want))
        for want, got in zip(J.hh_rank(*js[name]), T.hh_rank(*ts[name])):
            np.testing.assert_array_equal(got.numpy(), _np(want))
    want = _np(J.topk_merge(jnp.stack([js["a"][1], js["b"][1]])))
    ab = T.topk_merge(torch.stack([ts["a"][1], ts["b"][1]]))
    ba = T.topk_merge(torch.stack([ts["b"][1], ts["a"][1]]))
    np.testing.assert_array_equal(ab.numpy(), want)
    np.testing.assert_array_equal(ba.numpy(), want)  # commutative bit for bit


def test_topk_merge_of_many_ledgers_with_shared_keys():
    rng = np.random.default_rng(9)
    led = np.stack([rng.integers(-1, 12, (5, 6)), rng.integers(0, 40, (5, 6))], axis=-1).astype(np.int32)
    np.testing.assert_array_equal(T.topk_merge(torch.from_numpy(led)).numpy(), _np(J.topk_merge(jnp.asarray(led))))


def test_cms_update_never_reads_a_tensor_on_the_host():
    """On ``meta`` tensors any ``.item()`` or Python ``if`` on a tensor raises.
    The plain ledger walk only enqueues work; ``cms_update`` off the CPU
    goes to the walk kernel's wrapper, which gets to its device check (and
    raises there on ``meta``) without a host read, so on the card it never
    waits."""
    counts = torch.zeros((4, 64), dtype=torch.int32, device="meta")
    ledger = torch.zeros((8, 2), dtype=torch.int32, device="meta")
    ids = torch.zeros(5, dtype=torch.int32, device="meta")
    out_counts, out_ledger = cms_walk.cms_walk_reference(counts, ledger, ids)
    assert out_counts.shape == (4, 64) and out_ledger.shape == (8, 2)
    with pytest.raises(ValueError, match="cms_walk_cuda: tensors must lie on a CUDA device or the CPU, got meta"):
        T.cms_update(counts, ledger, ids)


def test_cms_update_leaves_its_inputs_alone():
    counts = torch.zeros((2, 16), dtype=torch.int32)
    ledger = torch.from_numpy(_empty_ledger(4))
    T.cms_update(counts, ledger, torch.tensor([1, 2, 2, 3], dtype=torch.int32))
    assert not counts.any() and torch.equal(ledger, torch.from_numpy(_empty_ledger(4)))


# --------------------------------------------------------------------- classes


def _stream(kind, rng, n_batches, n):
    if kind == "quantile":
        return [(rng.standard_normal(n) * rng.lognormal(0, 2, n)).astype(np.float32) for _ in range(n_batches)]
    if kind == "hh":
        return [(rng.zipf(1.2, n) % 300).astype(np.int32) for _ in range(n_batches)]
    return [(rng.zipf(1.1, n) % 10**6).astype(np.int32) for _ in range(n_batches)]


CLASSES = {
    # kind: (JAX metric, port metric, batch size, batches)
    "quantile": (lambda: JaxQuantile(quantiles=(0.1, 0.5, 0.99)),
                 lambda: QuantileSketch(quantiles=(0.1, 0.5, 0.99), device="cpu"), 3000, 4),
    "cardinality": (lambda: JaxCardinality(p=10), lambda: CardinalitySketch(p=10, device="cpu"), 3000, 4),
    "hh": (lambda: JaxHeavyHitters(k=16, depth=3, width=256),
           lambda: HeavyHittersSketch(k=16, depth=3, width=256, device="cpu"), 300, 2),
}


def _assert_values_close(got, want):
    if isinstance(want, tuple):  # heavy hitters: (keys, counts), int32, exact
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), _np(w))
    else:
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=0)


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_functional_api_and_merge_match_jax(kind):
    make_jax, make_port, n, n_batches = CLASSES[kind]
    batches = _stream(kind, np.random.default_rng(3), n_batches, n)
    half = n_batches // 2
    jm, tm = make_jax(), make_port()

    def run(metric, conv, part):
        state = metric.init_state()
        for b in part:
            state = metric.update_state(state, conv(b))
        return state

    js = run(jm, jnp.asarray, batches)
    ts = run(tm, torch.from_numpy, batches)
    _assert_state_equal(js, ts)
    _assert_values_close(tm.compute_from(ts), jm.compute_from(js))

    jmerged = jm.merge_states(run(jm, jnp.asarray, batches[:half]), run(jm, jnp.asarray, batches[half:]))
    tmerged = tm.merge_states(run(tm, torch.from_numpy, batches[:half]), run(tm, torch.from_numpy, batches[half:]))
    _assert_state_equal(jmerged, tmerged)
    # sums, maxes and min/max fold exactly: the merged state is the single-stream state
    exact = [name for name in ts if name != "ledger"]
    for name in exact:
        assert torch.equal(torch.as_tensor(tmerged[name]), torch.as_tensor(ts[name])), name


def test_stateful_update_compute_reset_and_twins():
    rng = np.random.default_rng(8)
    vals = rng.lognormal(0, 2, 4000).astype(np.float32)
    ids = (rng.zipf(1.2, 3000) % 500).astype(np.int32)
    for port, twin, jax_twin, x in (
        (QuantileSketch(device="cpu"), lambda t: approx_quantiles(t), jax_fsketch.approx_quantiles, vals),
        (CardinalitySketch(device="cpu"), lambda t: approx_count_distinct(t), jax_fsketch.approx_count_distinct, ids),
        (HeavyHittersSketch(device="cpu"), lambda t: approx_heavy_hitters(t), jax_fsketch.approx_heavy_hitters, ids),
    ):
        port.update(torch.from_numpy(x))
        value = port.compute()
        twin_value = twin(torch.from_numpy(x))
        if isinstance(value, tuple):
            for a, b in zip(value, twin_value):
                assert torch.equal(a, b)
        else:
            assert torch.equal(value, twin_value)  # the same kernels: bit-identical
        _assert_values_close(twin_value, jax_twin(jnp.asarray(x)))
        port.reset()
        assert port.update_count == 0 and not port.update_called


def test_quantile_from_and_topk_from():
    rng = np.random.default_rng(2)
    vals = rng.lognormal(0, 1, 3000).astype(np.float32)
    jq, tq = JaxQuantile(), QuantileSketch(device="cpu")
    js = jq.update_state(jq.init_state(), jnp.asarray(vals))
    ts = tq.update_state(tq.init_state(), torch.from_numpy(vals))
    np.testing.assert_allclose(float(tq.quantile_from(ts, 0.75)), float(jq.quantile_from(js, 0.75)), rtol=RTOL)
    np.testing.assert_allclose(tq.quantile_from(ts, [0.2, 0.8]).numpy(), _np(jq.quantile_from(js, [0.2, 0.8])), rtol=RTOL)
    ids = (rng.zipf(1.2, 500) % 50).astype(np.int32)
    jh, th = JaxHeavyHitters(k=8), HeavyHittersSketch(k=8, device="cpu")
    jhs = jh.update_state(jh.init_state(), jnp.asarray(ids))
    ths = th.update_state(th.init_state(), torch.from_numpy(ids))
    for a, b in zip(th.topk_from(ths, 3), jh.topk_from(jhs, 3)):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    with pytest.raises(ValueError, match="ledger size"):
        th.topk_from(ths, 9)
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        tq.quantile_from(ts, 1.5)


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda: QuantileSketch(quantiles=(), device="cpu"), "non-empty"),
        (lambda: QuantileSketch(quantiles=(1.2,), device="cpu"), "non-empty"),
        (lambda: QuantileSketch(n_buckets=1, device="cpu"), "n_buckets"),
        (lambda: QuantileSketch(alpha=1.5, device="cpu"), "alpha"),
        (lambda: CardinalitySketch(p=3, device="cpu"), "`p`"),
        (lambda: CardinalitySketch(p=17, device="cpu"), "`p`"),
        (lambda: HeavyHittersSketch(k=0, device="cpu"), "`k`"),
        (lambda: HeavyHittersSketch(width=1, device="cpu"), "width"),
        (lambda: approx_count_distinct(torch.zeros(3), p=20), "`p`"),
    ],
)
def test_bad_configuration_raises_as_in_jax(make, match):
    with pytest.raises(ValueError, match=match):
        make()


def test_misconfiguration_warning():
    with pytest.warns(UserWarning, match="only tracks magnitudes"):
        QuantileSketch(n_buckets=512, device="cpu")


def test_states_are_int32_and_on_the_given_device():
    q = QuantileSketch(device="cpu").init_state()
    assert q["pos_buckets"].dtype == q["zero_count"].dtype == q["_update_count"].dtype == torch.int32
    assert q["min_value"].dtype == torch.float32 and float(q["min_value"]) == math.inf
    h = HeavyHittersSketch(k=4, device="cpu").init_state()
    assert h["ledger"].tolist() == [[-1, 0]] * 4 and h["counts"].dtype == torch.int32


# --------------------------------------------------------------------- accuracy


def _dd_rel_err(est, vals, q):
    oracle = float(np.quantile(vals, q, method="lower"))
    return abs(float(est) - oracle) / max(abs(oracle), 1e-12)


ACC_STREAMS = [
    ("lognormal", (0.01, 0.25, 0.5, 0.9, 0.99)),
    ("uniform", (0.05, 0.5, 0.95)),
    ("neg_lognormal", (0.1, 0.5, 0.9)),
    ("mixed_sign", (0.05, 0.2, 0.8, 0.95)),
]


@pytest.mark.parametrize("name,qs", ACC_STREAMS, ids=[s[0] for s in ACC_STREAMS])
def test_quantile_relative_error_within_alpha(name, qs):
    vals = DD_STREAMS[name](np.random.default_rng(0), 20_000).astype(np.float32)
    ests = approx_quantiles(torch.from_numpy(vals), qs, alpha=0.01)
    for q, est in zip(qs, ests.tolist()):
        assert _dd_rel_err(est, vals, q) <= 0.01, f"{name} q={q}"
    ext = approx_quantiles(torch.from_numpy(vals), (0.0, 1.0))
    assert ext.tolist() == [float(vals.min()), float(vals.max())]


@pytest.mark.parametrize("true_n", [100, 3_000, 30_000])
def test_cardinality_within_three_sigma(true_n):
    p = 12
    rng = np.random.default_rng(true_n)
    ids = rng.choice(10_000_000, size=true_n, replace=False)
    stream = np.concatenate([ids, rng.choice(ids, size=max(true_n * 2, 1_000))]).astype(np.int32)
    est = float(approx_count_distinct(torch.from_numpy(stream), p=p))
    assert abs(est - true_n) / true_n <= 3 * 1.04 / np.sqrt(1 << p)


def test_heavy_hitters_recall_and_count_envelope():
    rng = np.random.default_rng(0)
    width = 2048
    heavy_ids = rng.choice(np.arange(1000, 1200), size=20, replace=False)
    noise = rng.integers(10_000, 110_000, 6000)
    stream = np.concatenate([np.repeat(heavy_ids, 300), noise]).astype(np.int32)
    rng.shuffle(stream)
    keys, counts = approx_heavy_hitters(torch.from_numpy(stream), k=32, depth=4, width=width)
    reported = {int(k): int(c) for k, c in zip(keys.tolist(), counts.tolist()) if k >= 0}
    assert set(int(i) for i in heavy_ids) <= set(reported)
    eps_n = np.e * len(stream) / width
    for hid in heavy_ids:
        true = 300 + int((noise == hid).sum())
        assert true <= reported[int(hid)] <= true + 2 * eps_n  # count-min never undercounts
    live = counts[keys >= 0]
    assert bool((live[1:] <= live[:-1]).all())


# --------------------------------------------------------------------- carry-over


def test_jax_states_carry_over_and_answer_the_same():
    """A JAX functional state (int32 buckets, float32 min/max at +-inf, the
    (k, 2) ledger, the int32 _update_count) converts through
    ``metric_state_from_jax`` and answers the same through ``compute_from``."""
    rng = np.random.default_rng(6)
    pairs = [
        (JaxQuantile(), QuantileSketch(device="cpu"), rng.lognormal(0, 2, 3000).astype(np.float32)),
        (JaxCardinality(p=12), CardinalitySketch(p=12, device="cpu"), (rng.zipf(1.1, 3000) % 10**6).astype(np.int32)),
        (JaxHeavyHitters(k=8), HeavyHittersSketch(k=8, device="cpu"), (rng.zipf(1.2, 500) % 40).astype(np.int32)),
    ]
    for jm, tm, batch in pairs:
        for js in (jm.init_state(), jm.update_state(jm.init_state(), jnp.asarray(batch))):
            ts = metric_state_from_jax(jax.tree_util.tree_map(np.asarray, js), device="cpu")
            _assert_state_equal(js, ts)
            assert ts["_update_count"].dtype == torch.int32
            got, want = tm.compute_from(ts), jm.compute_from(js)
            if isinstance(want, tuple):
                _assert_values_close(got, want)
            else:
                np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=0, equal_nan=True)
            # and the carried state keeps accumulating exactly as the JAX one does
            _assert_state_equal(jm.update_state(js, jnp.asarray(batch)), tm.update_state(ts, torch.from_numpy(batch)))


def test_no_kernel_launch_on_the_cpu():
    before = dict(scatter.launches)
    QuantileSketch(device="cpu").update(torch.ones(10))
    CardinalitySketch(device="cpu").update(torch.ones(10, dtype=torch.int32))
    T.cms_table_update(torch.zeros((4, 64), dtype=torch.int32), torch.ones(10, dtype=torch.int32))
    assert scatter.launches == before
