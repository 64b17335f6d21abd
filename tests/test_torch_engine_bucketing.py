"""The port's bucketing (``metrics_tpu_torch/engine/bucketing.py``) against the JAX
package's, on the CPU: the bucket choice, signatures (with the JAX package's
canonical dtypes: int64 -> int32, float64 -> float32), the padded layout, the
row split, the tuned ladder (the same trace gives the same ladder), and zero
contribution from padded rows through both engines."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.engine.bucketing as jb
import metrics_tpu_torch.engine.bucketing as tb
from metrics_tpu.utils.exceptions import MetricsTPUUserError as JaxUserError
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from tests.test_torch_engine import (  # noqa: F401  (_one_torch_thread: the autouse fixture)
    FAMILIES,
    _one_torch_thread,
    assert_trees_match,
    run_both,
)


def test_choose_bucket_matches_jax():
    buckets = tb.normalize_buckets((8, 64, 16, 8))
    assert buckets == jb.normalize_buckets((8, 64, 16, 8)) == (8, 16, 64)
    for n in range(1, 100):
        b = tb.choose_bucket(n, buckets)
        assert b == jb.choose_bucket(n, buckets)
        assert b == (64 if n > 64 else min(x for x in buckets if x >= n))


@pytest.mark.parametrize("bad", [(), (0, 4), (-1,)])
def test_normalize_buckets_rejects_bad(bad):
    with pytest.raises(MetricsTPUUserError):
        tb.normalize_buckets(bad)
    with pytest.raises(JaxUserError):
        jb.normalize_buckets(bad)


def test_bucket_config_normalizes_like_a_sequence():
    assert tb.normalize_buckets(tb.BucketConfig(ladder=(64, 8, 8))) == (8, 64)
    assert tb.BucketConfig().normalized() == jb.BucketConfig().normalized()
    assert tb.DEFAULT_BUCKETS == jb.DEFAULT_BUCKETS


ARRAYS = [
    ("float32", lambda: np.zeros((3, 5), np.float32)),
    ("float64", lambda: np.zeros((3, 5), np.float64)),
    ("int64", lambda: np.zeros(3, np.int64)),
    ("int32", lambda: np.zeros(3, np.int32)),
    ("uint8", lambda: np.zeros((3, 2, 2), np.uint8)),
    ("bool", lambda: np.zeros(3, bool)),
    ("list", lambda: [1.0, 2.0, 3.0]),
]


@pytest.mark.parametrize("name,make", ARRAYS, ids=[a[0] for a in ARRAYS])
def test_inspect_request_signature_matches_jax(name, make):
    """Numpy arrays, lists and tensors of the same data have the JAX package's
    signature (its canonical dtypes)."""
    arr = make()
    want = jb.inspect_request((arr, np.zeros(3, np.int64)))
    assert tb.inspect_request((arr, np.zeros(3, np.int64))) == want
    tensor = torch.as_tensor(np.asarray(arr))
    assert tb.inspect_request((tensor, torch.zeros(3, dtype=torch.int64))) == want


@pytest.mark.parametrize(
    "args,match",
    [((np.asarray(1.0),), "leading batch axis"), ((np.zeros(3), np.zeros(4)), "disagree on the leading axis"),
     ((), "at least one array")],
)
def test_inspect_request_errors_match_jax(args, match):
    with pytest.raises(MetricsTPUUserError, match=match):
        tb.inspect_request(args)
    with pytest.raises(JaxUserError, match=match):
        jb.inspect_request(args)


REQUESTS = [
    (2, (np.array([1.0, 2.0]), np.array([0, 1])), 2),
    (0, (np.array([3.0]), np.array([1])), 1),
    (5, (np.array([4.5, -1.0, 7.25]), np.array([2**31 + 3, -2, 9], np.int64)), 3),
]


@pytest.mark.parametrize("bucket", [6, 8, 32])
def test_pad_micro_batch_matches_jax(bucket):
    """Rows back to back in submission order, ``(bucket, 1, *trailing)``, the
    narrowed dtypes (int64 labels by their low word), padding rows carrying the
    first request's slot and masked out."""
    cols, kids, mask, (hcols, hkids, hmask) = tb.pad_micro_batch(REQUESTS, bucket)
    jcols, jkids, jmask = jb.pad_micro_batch(REQUESTS, bucket)
    for got, host, want in zip(cols, hcols, jcols):
        assert got.shape == (bucket, 1) and str(got.dtype).endswith(str(want.dtype))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # the host arrays the WAL journals are the columns' values and dtypes
        assert host.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(host, np.asarray(want))
    assert kids.dtype == torch.int32 and mask.dtype == torch.bool
    np.testing.assert_array_equal(kids.numpy(), np.asarray(jkids))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert hkids.dtype == np.int32 and hmask.dtype == np.bool_
    np.testing.assert_array_equal(hkids, np.asarray(jkids))
    np.testing.assert_array_equal(hmask, np.asarray(jmask))
    assert set(kids[6:].tolist()) <= {2}
    again = tb.pad_micro_batch(REQUESTS, bucket)
    assert all(torch.equal(a, b) for a, b in zip((*cols, kids, mask), (*again[0], again[1], again[2])))


def test_pad_micro_batch_takes_tensors_and_trailing_shapes():
    reqs = [(1, (torch.arange(6, dtype=torch.float64).reshape(3, 2),), 3), (0, (np.ones((1, 2), np.float32),), 1)]
    (col,), kids, mask, _ = tb.pad_micro_batch(reqs, 4)
    assert col.shape == (4, 1, 2) and col.dtype == torch.float32
    assert torch.equal(col[:, 0], torch.tensor([[0.0, 1.0], [2.0, 3.0], [4.0, 5.0], [1.0, 1.0]]))
    assert kids.tolist() == [1, 1, 1, 0] and mask.all()


def test_pad_micro_batch_overflow_raises():
    with pytest.raises(MetricsTPUUserError, match="exceeds bucket"):
        tb.pad_micro_batch([(0, (np.zeros(9),), 9)], bucket=8)


def test_as_request_tensor_narrows_like_the_columns():
    assert tb.as_request_tensor(np.array([2**31 + 3], np.int64), "cpu").tolist() == [-(2**31) + 3]
    assert tb.as_request_tensor(np.array([0.1]), "cpu").dtype == torch.float32
    assert tb.as_request_tensor(torch.tensor([1, 2], dtype=torch.int16), "cpu").dtype == torch.int16


def test_split_rows_matches_jax():
    args = (np.arange(10.0), np.arange(10))
    chunks, jchunks = tb.split_rows(args, 4), jb.split_rows((jnp.arange(10.0), jnp.arange(10)), 4)
    assert [r for _, r in chunks] == [r for _, r in jchunks] == [4, 4, 2]
    np.testing.assert_array_equal(chunks[2][0][0], [8.0, 9.0])
    assert tb.split_rows(args, 16) == [(args, 10)]


TRACES = {
    "skewed": [int(r) for r in np.random.default_rng(0).choice([3, 24, 200], 4000, p=[0.6, 0.3, 0.1])],
    "weighted": {10: 100.0, 11: 90.0, 12: 80.0, 100: 10.0, 5000: 1.0},
    "single": [7, 7, 7],
    "junk": {4: 0.0, -3: 5.0},
    "empty": [],
    "wide": [int(r) for r in np.random.default_rng(1).integers(1, 2000, 30000)],
    "dominant": {33: 1_000_000.0, **{1000 + i: 1.0 for i in range(600)}},
}


@pytest.mark.parametrize("name", sorted(TRACES))
@pytest.mark.parametrize("max_buckets,max_rows", [(4, 256), (2, 256), (6, 2048)])
def test_tune_buckets_matches_jax(name, max_buckets, max_rows):
    """The dynamic program (with its weight-quantile grid past 512 sizes) gives
    the JAX package's ladder for the same trace."""
    got = tb.tune_buckets(TRACES[name], max_buckets=max_buckets, max_rows=max_rows)
    assert got == jb.tune_buckets(TRACES[name], max_buckets=max_buckets, max_rows=max_rows)
    assert 1 <= len(got) <= max(max_buckets, len(tb.DEFAULT_BUCKETS))


def test_tune_buckets_edge_cases():
    assert tb.tune_buckets(TRACES["skewed"], max_buckets=4) == (3, 24, 200)
    assert tb.tune_buckets([]) == tb.DEFAULT_BUCKETS
    assert tb.tune_buckets([7, 7, 7]) == (7,)
    with pytest.raises(MetricsTPUUserError):
        tb.tune_buckets([4], max_buckets=0)


@pytest.mark.parametrize("family", ["accuracy", "heavy_hitters"])
def test_padded_rows_contribute_zero(family):
    """One request of 3 rows in a bucket of 8: the state equals the JAX engine's,
    the padding counted and never applied."""
    rng = np.random.default_rng(2)
    stream = [("t", FAMILIES[family][2](rng, 3))]
    p_snap, r_snap, p_states, r_states, _, _ = run_both(family, stream, buckets=(8,))
    assert (p_snap["padded_rows"], p_snap["rows"]) == (r_snap["padded_rows"], r_snap["rows"]) == (5, 3)
    assert_trees_match(p_states["t"], r_states["t"])
    assert int(p_states["t"]["_update_count"]) == 3


def test_engine_accepts_bucket_config_and_tuned_ladder():
    from metrics_tpu_torch.engine import StreamingEngine

    ladder = tb.tune_buckets([2, 2, 2, 6, 6, 30])
    engine = StreamingEngine(FAMILIES["accuracy"][1](), buckets=tb.BucketConfig(ladder=ladder))
    try:
        assert engine._buckets == tuple(sorted(set(ladder)))
        engine.submit("t", np.array([1, 0], np.int32), np.array([1, 1], np.int32))
        assert float(engine.compute("t")) == 0.5
    finally:
        engine.close()
