"""The fixed-state regression metrics served by the port's StreamingEngine
against the JAX package's engine, on the CPU.

``R2Score``, ``PearsonCorrCoef``, ``ExplainedVariance``,
``TweedieDevianceScore`` (powers 0 and 1.5) and ``KLDivergence`` with its
"mean" reduction (rows of 5 probabilities) hold fixed-shape float32 states
and no ``_host_compute``, so both engines fuse them: every micro-batch is the
masked scan (one CUDA-graph replay on the card, a loop here). The same
numpy-seeded stream (1-6 rows a request, 3 tenants) goes through both
engines in one drained batch each; every tenant's state and value are
compared leaf by leaf (``assert_trees_match``: float leaves within rtol 1e-6,
the same float32 operations a row in both), and each state equals the port's
own row-by-row fold bit for bit. The list-state regression metrics
(``SpearmanCorrCoef``, ``KLDivergence(reduction=None)``) are served eagerly
by both engines.
"""

import numpy as np
import pytest
import torch

import metrics_tpu.regression as jax_reg
import metrics_tpu_torch.regression as torch_reg
from metrics_tpu.engine import StreamingEngine as JaxEngine
from metrics_tpu_torch.engine import StreamingEngine
from tests.test_torch_engine import (  # noqa: F401  (_one_torch_thread: the autouse fixture)
    _one_torch_thread,
    _stream,
    assert_trees_match,
    engine_states,
    fold_rows,
    run_stream,
)

CPU = {"device": "cpu"}


def _signed(rng, rows):
    target = rng.normal(3.0, 1.0, rows).astype(np.float32)
    return (0.8 * target + rng.normal(0.5, 0.5, rows)).astype(np.float32), target


def _positive(rng, rows):
    return (rng.random(rows) * 2 + 0.5).astype(np.float32), (rng.random(rows) * 2 + 0.5).astype(np.float32)


def _distributions(rng, rows):
    return tuple((rng.random((rows, 5)) + 0.1).astype(np.float32) for _ in range(2))


# name -> (class, constructor arguments, request generator)
SERVED = {
    "r2": ("R2Score", {}, _signed),
    "r2_adjusted": ("R2Score", {"adjusted": 2}, _signed),
    "pearson": ("PearsonCorrCoef", {}, _signed),
    "explained_variance": ("ExplainedVariance", {}, _signed),
    "tweedie": ("TweedieDevianceScore", {}, _signed),
    "tweedie_1.5": ("TweedieDevianceScore", {"power": 1.5}, _positive),
    "kl_divergence": ("KLDivergence", {}, _distributions),
}


@pytest.mark.parametrize("name", sorted(SERVED))
def test_fixed_state_regression_metrics_fuse_and_match_jax(name):
    cls, kw, gen = SERVED[name]
    stream = _stream(gen, seed=len(name), n=30, keys=3)
    ref = JaxEngine(getattr(jax_reg, cls)(**kw), buckets=(8,), capacity=4)
    port = StreamingEngine(getattr(torch_reg, cls)(**kw, **CPU), buckets=(8,), capacity=4)
    try:
        run_stream(ref, stream, one_drain=True)
        run_stream(port, stream, one_drain=True)
        p_snap, r_snap = port.telemetry_snapshot(), ref.telemetry_snapshot()
        p_states, r_states = engine_states(port), engine_states(ref)
        p_vals, r_vals = port.compute_all(), ref.compute_all()
    finally:
        port.close()
        ref.close()
    assert p_snap["fused"] and r_snap["fused"]
    assert p_snap["fused_fallbacks"] == r_snap["fused_fallbacks"] == 0
    assert p_snap["processed"] == r_snap["processed"] == len(stream)
    assert (p_snap["rows"], p_snap["batches"]) == (r_snap["rows"], r_snap["batches"])
    assert set(p_states) == set(r_states) and len(p_states) == 3
    folds = fold_rows(getattr(torch_reg, cls)(**kw, **CPU), stream)
    for key in r_states:
        assert_trees_match(p_states[key], r_states[key], key)
        assert_trees_match(p_vals[key], r_vals[key], key)
        for leaf, value in folds[key].items():
            got = p_states[key][leaf]
            assert torch.equal(torch.as_tensor(got), torch.as_tensor(value)), (key, leaf)


@pytest.mark.parametrize("cls,kw", [("SpearmanCorrCoef", {}), ("KLDivergence", {"reduction": None})])
def test_list_state_regression_metrics_are_served_eagerly_by_both(cls, kw):
    """A list state cannot stack along the tenant axis: both engines serve
    these on their eager path, with equal values."""
    rng = np.random.default_rng(4)
    if cls == "KLDivergence":
        reqs = [(f"t{i % 2}", tuple((rng.random((2, 5)) + 0.1).astype(np.float32) for _ in range(2)))
                for i in range(8)]
    else:
        reqs = [(f"t{i % 2}", _signed(rng, 3)) for i in range(8)]
    ref = JaxEngine(getattr(jax_reg, cls)(**kw), buckets=(8,))
    port = StreamingEngine(getattr(torch_reg, cls)(**kw, **CPU), buckets=(8,))
    try:
        run_stream(ref, reqs)
        run_stream(port, reqs)
        assert not port.telemetry_snapshot()["fused"] and not ref.telemetry_snapshot()["fused"]
        p_vals, r_vals = port.compute_all(), ref.compute_all()
    finally:
        port.close()
        ref.close()
    for key in r_vals:
        np.testing.assert_allclose(p_vals[key].numpy(), np.asarray(r_vals[key]), rtol=1e-5, atol=1e-6)
