"""The port's ``CompositionalMetric`` and the operator overloads on ``Metric``
against the JAX package's, on the CPU.

Every overload is applied to two ``MeanMetric``s and to a metric and a
constant (a Python int, a float, a float64 numpy array), in both orders; the
bitwise ones, ``@``, ``//``, ``%`` and ``[]`` to the int32 output of
``MulticlassStatScores(average="micro")``. Values must agree within rtol=1e-6
(float32 arithmetic on the same operands) and dtypes exactly: a constant keeps
the dtype ``jnp.asarray`` gives it with x64 off (int32, float32).
"""

import operator

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.aggregation as jax_agg
import metrics_tpu.classification as jax_cls
from metrics_tpu.metric import CompositionalMetric as JaxCompositional
import metrics_tpu_torch.aggregation as torch_agg
import metrics_tpu_torch.classification as torch_cls
from metrics_tpu_torch.metric import CompositionalMetric, Metric

MEAN_A = np.array([1.5, 2.0, 1.75], np.float32)
MEAN_B = np.array([-0.5, 0.75], np.float32)
PREDS = [np.array([0, 1, 2, 3, 1, 1, 2]), np.array([3, 3, 0, 1, 2, 2, 0])]
TARGET = [np.array([0, 1, 1, 3, 2, 1, 2]), np.array([3, 0, 0, 1, 2, 1, 1])]


def _means(pkg):
    """Two updated MeanMetrics of one package (values 1.75 and 0.125)."""
    if pkg == "jax":
        a, b = jax_agg.MeanMetric(), jax_agg.MeanMetric()
        a.update(jnp.asarray(MEAN_A))
        b.update(jnp.asarray(MEAN_B))
    else:
        a, b = torch_agg.MeanMetric(device="cpu"), torch_agg.MeanMetric(device="cpu")
        a.update(torch.from_numpy(MEAN_A))
        b.update(torch.from_numpy(MEAN_B))
    return a, b


def _stat_scores(pkg):
    """Two updated int32 micro stat-score metrics of one package ([tp, fp, tn, fn, support])."""
    out = []
    for p, t in zip(PREDS, TARGET):
        if pkg == "jax":
            m = jax_cls.MulticlassStatScores(4, average="micro")
            m.update(jnp.asarray(p), jnp.asarray(t))
        else:
            m = torch_cls.MulticlassStatScores(4, average="micro", device="cpu")
            m.update(torch.from_numpy(p), torch.from_numpy(t))
        out.append(m)
    return out


def _check(got, want):
    want = np.asarray(want)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype), (got.dtype, want.dtype)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


BINARY = [operator.add, operator.sub, operator.mul, operator.truediv, operator.floordiv, operator.mod,
          operator.pow, operator.lt, operator.le, operator.gt, operator.ge, operator.eq, operator.ne]
CONSTANTS = {"int": 3, "float": 2.5, "ndarray": np.array([1.0, 2.0])}


# a numpy array on the left broadcasts over the metric as an object: numpy, not the metric, handles it
OPERANDS = [(other, False) for other in ("metric", "int", "float", "ndarray")] + [
    (other, True) for other in ("metric", "int", "float")
]


@pytest.mark.parametrize("op", BINARY, ids=lambda f: f.__name__)
@pytest.mark.parametrize("other,reflected", OPERANDS, ids=[f"{o}-{'second' if r else 'first'}" for o, r in OPERANDS])
def test_binary_overloads_on_means_match_jax(op, other, reflected):
    results = []
    for pkg in ("jax", "torch"):
        a, b = _means(pkg)
        rhs = b if other == "metric" else CONSTANTS[other]
        combo = op(rhs, a) if reflected else op(a, rhs)
        assert isinstance(combo, JaxCompositional if pkg == "jax" else CompositionalMetric)
        results.append(combo.compute())
    _check(results[1], results[0])


@pytest.mark.parametrize("op", [operator.abs, operator.neg, operator.pos], ids=lambda f: f.__name__)
def test_unary_overloads_match_jax(op):
    """On a negative value: the JAX package's unary minus is -|x| and its unary plus |x|."""
    want = op(_means("jax")[0] - 2.0).compute()
    got = op(_means("torch")[0] - 2.0).compute()
    _check(got, want)


INT_CASES = {
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "xor": lambda a, b: a ^ b,
    "rand_int": lambda a, b: 6 & a,
    "ror_int": lambda a, b: 6 | a,
    "rxor_int": lambda a, b: 6 ^ a,
    "invert": lambda a, b: ~a,
    "matmul": lambda a, b: a @ b,
    "floordiv_int": lambda a, b: a // 2,
    "rfloordiv_int": lambda a, b: 20 // b,
    "mod_int": lambda a, b: a % 3,
    "rmod_int": lambda a, b: 7 % b,
    "pow_int": lambda a, b: a ** 2,
    "rpow_int": lambda a, b: 2 ** a,
    "truediv_int": lambda a, b: a / 2,
    "mul_float": lambda a, b: a * 0.5,
    "getitem": lambda a, b: a[1],
    "getitem_slice": lambda a, b: b[1:4],
    "sub_metrics": lambda a, b: a - b,
}


@pytest.mark.parametrize("name", list(INT_CASES))
def test_overloads_on_int32_states_match_jax(name):
    fn = INT_CASES[name]
    want = fn(*_stat_scores("jax")).compute()
    got = fn(*_stat_scores("torch")).compute()
    _check(got, want)


def test_constants_take_the_jax_dtypes_and_the_metrics_device():
    a, _ = _means("torch")
    for const, dtype in ((3, torch.int32), (2.5, torch.float32), (np.float64(2.5), torch.float32),
                         (np.array([1, 2]), torch.int32), (np.array([1.0]), torch.float32)):
        combo = a + const
        assert combo.metric_b.dtype == dtype and combo.metric_b.device == a.device == combo.device
    assert (a + True).metric_b is True  # a bool stays a Python bool, as in the JAX package
    t = torch.tensor([1.0, 2.0], dtype=torch.float64)
    assert (a * t).metric_b is t  # a tensor is taken as it is


def test_update_forward_reset_recurse_and_filter_kwargs():
    """``update``/``forward`` pass each child only the kwargs its ``update`` takes."""
    batches = [(np.array([1.0, 2.0, 4.0], np.float32), np.array([1.0, 0.5, 2.0], np.float32)),
               (np.array([3.0], np.float32), np.array([4.0], np.float32))]
    jc = jax_agg.MeanMetric() + jax_agg.SumMetric()
    tc = torch_agg.MeanMetric(device="cpu") + torch_agg.SumMetric(device="cpu")
    for v, w in batches:
        _check(tc(torch.from_numpy(v), weight=torch.from_numpy(w)), jc(jnp.asarray(v), weight=jnp.asarray(w)))
    tc.update(torch.from_numpy(batches[0][0]), weight=torch.from_numpy(batches[0][1]))
    jc.update(jnp.asarray(batches[0][0]), weight=jnp.asarray(batches[0][1]))
    _check(tc.compute(), jc.compute())
    tc.reset()
    assert tc.metric_a.update_count == 0 and float(tc.metric_b.sum_value) == 0.0
    assert torch_agg.MeanMetric(device="cpu")._filter_kwargs(weight=1, other=2) == {"weight": 1}
    assert torch_agg.SumMetric(device="cpu")._filter_kwargs(weight=1) == {}


def test_forward_of_a_constant_composition_and_of_none():
    a = torch_agg.MeanMetric(device="cpu")
    assert float((a * 2)(torch.tensor([1.0, 3.0]))) == 4.0
    assert float(abs(a)(torch.tensor([-1.0, -3.0]))) == 2.0


def test_persistent_and_state_dict_recurse_into_children_like_jax():
    jc = jax_agg.MeanMetric() - 2 * jax_agg.MaxMetric()
    tc = torch_agg.MeanMetric(device="cpu") - 2 * torch_agg.MaxMetric(device="cpu")
    assert not tc._any_persistent()
    jc.persistent(True)
    tc.persistent(True)
    assert tc._any_persistent() and tc.metric_b.metric_b._persistent["max_value"]
    x = np.array([0.5, 3.0, 1.0], np.float32)
    jc.update(jnp.asarray(x))
    tc.update(torch.from_numpy(x))
    jsd, tsd = jc.state_dict(), tc.state_dict()
    assert sorted(tsd) == sorted(jsd) == ["metric_a.mean_value", "metric_a.weight", "metric_b.metric_b.max_value"]
    for key, want in jsd.items():
        _check(tsd[key], want)
    fresh = torch_agg.MeanMetric(device="cpu") - 2 * torch_agg.MaxMetric(device="cpu")
    fresh.persistent(True)
    fresh.load_state_dict(jsd)  # a JAX state_dict loads into the port
    _check(fresh.compute(), jc.compute())
    with pytest.raises(KeyError, match="Unexpected"):
        fresh.load_state_dict({**jsd, "metric_b.max_value": jsd["metric_a.weight"]})
    with pytest.raises(KeyError, match="Missing"):
        fresh.load_state_dict({k: v for k, v in jsd.items() if k != "metric_a.weight"})


def test_eq_builds_a_metric_and_hash_keeps_instances_apart():
    a, b = _means("torch")
    assert isinstance(a == b, CompositionalMetric) and isinstance(a != b, CompositionalMetric)
    assert hash(a) != hash(b) and {a: 1, b: 2}[b] == 2
    assert a in [a] and a in {a}
    before = hash(a)
    a.update(torch.tensor([1.0]))  # a new state object: the hash follows the states, as in the JAX package
    assert hash(a) != before


def test_repr_and_device():
    a, b = _means("torch")
    combo = a + b
    assert repr(combo).startswith("CompositionalMetric(\n  add(\n    MeanMetric(),\n    MeanMetric()")
    assert combo.device == torch.device("cpu")


def test_composition_of_constants_only_resolves_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: device=None resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CompositionalMetric(operator.add, 1, 2)


def test_a_metric_is_not_a_truth_value_for_equality():
    """``==`` between metrics is a metric, so a ``Metric`` config attribute keeps
    two metrics apart in the collection's structural test (callable first)."""
    from metrics_tpu_torch.collections import MetricCollection

    a, b = _means("torch")
    assert isinstance(a, Metric) and callable(a)
    c1, c2 = a + 1, b + 1
    assert not MetricCollection._structurally_identical(c1, c2)


def test_docstring_example():
    import doctest

    import metrics_tpu_torch.metric as metric_module

    result = doctest.testmod(metric_module, verbose=False)
    assert result.failed == 0 and result.attempted > 0
