"""The port's ``MetricCollection`` against the JAX package's, on the CPU.

Each test builds the same collection in both packages and feeds both the same
numpy batches (C <= 10, N <= 256). ``compute_groups`` must equal the JAX
package's at construction (the structural seeding) and after the first update
(the value merge); int32 states are bit-identical; float values agree within
rtol=1e-6 (float32 divisions and a float sum over at most 10 classes, in
other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.aggregation as jax_agg
import metrics_tpu.classification as jax_cls
from metrics_tpu.collections import MetricCollection as JaxCollection
import metrics_tpu_torch.aggregation as torch_agg
import metrics_tpu_torch.classification as torch_cls
from metrics_tpu_torch.collections import MetricCollection
from tests.test_torch_metric import jax_in_one_device_mesh, world_of_one

C = 7


def _pkg(side):
    """``(classification, aggregation, MetricCollection, kwargs)`` of one package."""
    if side == "jax":
        return jax_cls, jax_agg, JaxCollection, {}
    return torch_cls, torch_agg, MetricCollection, {"device": "cpu"}


def _flagship(side, num_classes=C):
    cls, _, _, kw = _pkg(side)
    return {
        "accuracy": cls.MulticlassAccuracy(num_classes, average="micro", validate_args=False, **kw),
        "f1": cls.MulticlassF1Score(num_classes, average="macro", validate_args=False, **kw),
        "confmat": cls.MulticlassConfusionMatrix(num_classes, validate_args=False, **kw),
    }


def _six(side, num_classes=C):
    """The six-metric set of benchmarks/collections_vs_reference.py."""
    cls, _, _, kw = _pkg(side)
    return {
        "acc": cls.MulticlassAccuracy(num_classes, average="micro", **kw),
        "prec": cls.MulticlassPrecision(num_classes, average="macro", **kw),
        "rec": cls.MulticlassRecall(num_classes, average="macro", **kw),
        "f1": cls.MulticlassF1Score(num_classes, average="macro", **kw),
        "spec": cls.MulticlassSpecificity(num_classes, average="macro", **kw),
        "cm": cls.MulticlassConfusionMatrix(num_classes, **kw),
    }


def _mixed(side):
    """Stat-score metrics in several configurations (averages, top_k, ignore_index)."""
    cls, agg, _, kw = _pkg(side)
    return {
        "acc_macro": cls.MulticlassAccuracy(C, average="macro", **kw),
        "acc_top2": cls.MulticlassAccuracy(C, average="macro", top_k=2, **kw),
        "prec_ignore": cls.MulticlassPrecision(C, average="macro", ignore_index=0, **kw),
        "rec_ignore": cls.MulticlassRecall(C, average="macro", ignore_index=0, **kw),
        "rec_weighted": cls.MulticlassRecall(C, average="weighted", **kw),
        "stat": cls.MulticlassStatScores(C, average="none", **kw),
    }


def _batches(seed, n_batches=3, n=64, probs=False, num_classes=C):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        if probs:
            p = rng.random((n, num_classes)).astype(np.float32)
        else:
            p = rng.integers(0, num_classes, n)
        out.append((p, rng.integers(0, num_classes, n)))
    return out


def _to(side, batch):
    conv = jnp.asarray if side == "jax" else torch.from_numpy
    return tuple(conv(b) for b in batch)


def _close(got, want):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    want = np.asarray(want)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype), (got.dtype, want.dtype)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def _assert_states_equal(jcol, tcol):
    jm, tm = dict(jcol.items(keep_base=True)), dict(tcol.items(keep_base=True))
    assert list(tm) == list(jm)
    for name in jm:
        assert tm[name].update_count == jm[name].update_count, name
        for key in jm[name]._defaults:
            _close(getattr(tm[name], key), getattr(jm[name], key))


def _assert_values_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        _close(got[k], want[k])


SETS = {"flagship": _flagship, "six": _six, "mixed": _mixed}


@pytest.mark.parametrize("probs", [False, True], ids=["labels", "probs"])
@pytest.mark.parametrize("which", list(SETS))
def test_groups_states_and_values_match_jax(which, probs):
    jcol, tcol = JaxCollection(SETS[which]("jax")), MetricCollection(SETS[which]("torch"))
    assert tcol.compute_groups == jcol.compute_groups  # the structural seeding, before any data
    for i, batch in enumerate(_batches(seed=len(which), probs=probs)):
        jcol.update(*_to("jax", batch))
        tcol.update(*_to("torch", batch))
        assert tcol.compute_groups == jcol.compute_groups, i  # the value merge, after the first update
        _assert_states_equal(jcol, tcol)
    _assert_values_equal(tcol.compute(), jcol.compute())


def test_the_group_maps_the_jax_package_forms():
    flagship = MetricCollection(_flagship("torch", 10))
    six = MetricCollection(_six("torch", 100))
    assert flagship.compute_groups == {0: ["accuracy"], 1: ["confmat"], 2: ["f1"]}
    assert six.compute_groups == {0: ["acc"], 1: ["cm"], 2: ["f1"], 3: ["prec", "rec", "spec"]}
    batch = _batches(seed=9, n_batches=1, n=256, num_classes=100)[0]
    flagship.update(*_to("torch", (batch[0] % 10, batch[1] % 10)))
    six.update(*_to("torch", batch))
    assert flagship.compute_groups == {0: ["accuracy", "f1"], 1: ["confmat"]}
    assert six.compute_groups == {0: ["acc", "f1", "prec", "rec", "spec"], 1: ["cm"]}


@pytest.mark.parametrize("compute_groups", [False, [["acc", "prec", "rec"], ["f1", "spec"], ["cm"]]],
                         ids=["off", "explicit"])
def test_compute_groups_off_and_explicit_match_jax(compute_groups):
    jcol = JaxCollection(_six("jax"), compute_groups=compute_groups)
    tcol = MetricCollection(_six("torch"), compute_groups=compute_groups)
    assert tcol.compute_groups == jcol.compute_groups
    for batch in _batches(seed=2):
        jcol.update(*_to("jax", batch))
        tcol.update(*_to("torch", batch))
        assert tcol.compute_groups == jcol.compute_groups
        _assert_states_equal(jcol, tcol)
    _assert_values_equal(tcol.compute(), jcol.compute())


def test_explicit_groups_must_name_metrics():
    with pytest.raises(ValueError, match="does not match a metric"):
        MetricCollection(_six("torch"), compute_groups=[["acc", "nope"]])


def test_prefix_postfix_and_list_input_match_jax():
    def build(side):
        cls, agg, coll, kw = _pkg(side)
        return coll([cls.MulticlassAccuracy(C, **kw), cls.MulticlassRecall(C, **kw), agg.MeanMetric(**kw)],
                    prefix="val_", postfix="_x")

    jcol, tcol = build("jax"), build("torch")
    assert list(tcol.keys()) == list(jcol.keys()) == ["val_MulticlassAccuracy_x", "val_MulticlassRecall_x",
                                                      "val_MeanMetric_x"]
    assert tcol.compute_groups == jcol.compute_groups
    for p, t in _batches(seed=3):
        for side, col in (("jax", jcol), ("torch", tcol)):
            (pp, tt) = _to(side, (p, t))
            col.update(pp, tt)
        assert tcol.compute_groups == jcol.compute_groups
    with pytest.raises(ValueError, match="string"):
        MetricCollection([torch_agg.MeanMetric(device="cpu")], prefix=1)
    with pytest.raises(ValueError, match="two metrics both named"):
        MetricCollection([torch_agg.MeanMetric(device="cpu"), torch_agg.MeanMetric(device="cpu")])


def test_nested_collections_match_jax():
    def build(side):
        cls, agg, coll, kw = _pkg(side)
        inner = coll([cls.MulticlassAccuracy(C, **kw), cls.MulticlassPrecision(C, **kw)], prefix="in_")
        return coll({"outer": inner, "f1": cls.MulticlassF1Score(C, **kw)})

    jcol, tcol = build("jax"), build("torch")
    assert list(tcol.keys()) == list(jcol.keys())
    assert tcol.compute_groups == jcol.compute_groups
    for batch in _batches(seed=4):
        jcol.update(*_to("jax", batch))
        tcol.update(*_to("torch", batch))
        assert tcol.compute_groups == jcol.compute_groups
    _assert_states_equal(jcol, tcol)
    _assert_values_equal(tcol.compute(), jcol.compute())


def test_add_metrics_after_updates_matches_jax():
    jcol, tcol = JaxCollection(_flagship("jax")), MetricCollection(_flagship("torch"))
    batches = _batches(seed=5, n_batches=4)
    for batch in batches[:2]:
        jcol.update(*_to("jax", batch))
        tcol.update(*_to("torch", batch))
    jcol.add_metrics({"spec": jax_cls.MulticlassSpecificity(C, validate_args=False),
                      "prec": jax_cls.MulticlassPrecision(C, validate_args=False)})
    tcol.add_metrics({"spec": torch_cls.MulticlassSpecificity(C, validate_args=False, device="cpu"),
                      "prec": torch_cls.MulticlassPrecision(C, validate_args=False, device="cpu")})
    # a virgin metric is never seeded with one that carries history
    assert tcol.compute_groups == jcol.compute_groups == {i: [n] for i, n in enumerate(
        ["accuracy", "confmat", "f1", "prec", "spec"])}
    for batch in batches[2:]:
        jcol.update(*_to("jax", batch))
        tcol.update(*_to("torch", batch))
        assert tcol.compute_groups == jcol.compute_groups
        _assert_states_equal(jcol, tcol)
    _assert_values_equal(tcol.compute(), jcol.compute())


def test_forward_matches_jax_and_takes_one_update_per_group():
    jcol, tcol = JaxCollection(_six("jax")), MetricCollection(_six("torch"))
    batches = _batches(seed=6, n_batches=4)
    jcol.update(*_to("jax", batches[0]))
    tcol.update(*_to("torch", batches[0]))
    calls = []
    leader_update = tcol._modules["acc"].update

    def counted(*a, **k):
        calls.append(1)
        return leader_update(*a, **k)

    tcol._modules["acc"].update = counted
    for batch in batches[1:]:
        _assert_values_equal(tcol(*_to("torch", batch)), jcol(*_to("jax", batch)))
    del tcol._modules["acc"].update
    assert len(calls) == len(batches) - 1  # one forward (one update) of the leader, none of its members
    _assert_states_equal(jcol, tcol)
    _assert_values_equal(tcol.compute(), jcol.compute())


def test_forward_before_groups_form_matches_jax():
    jcol, tcol = JaxCollection(_flagship("jax")), MetricCollection(_flagship("torch"))
    for batch in _batches(seed=7, n_batches=2):
        _assert_values_equal(tcol(*_to("torch", batch)), jcol(*_to("jax", batch)))
    assert tcol.compute_groups == jcol.compute_groups


def test_state_dict_load_and_strictness_match_jax():
    jcol, tcol = JaxCollection(_six("jax")), MetricCollection(_six("torch"))
    jcol.persistent(True)
    tcol.persistent(True)
    for batch in _batches(seed=8):
        jcol.update(*_to("jax", batch))
        tcol.update(*_to("torch", batch))
    jsd, tsd = jcol.state_dict(), tcol.state_dict()
    assert list(tsd) == list(jsd)
    for key in jsd:
        _close(tsd[key], jsd[key])
    fresh = MetricCollection(_six("torch"))
    fresh.persistent(True)
    fresh.load_state_dict(jsd)  # a JAX state_dict loads into the port
    _assert_values_equal(fresh.compute(), jcol.compute())
    with pytest.raises(KeyError, match="Unexpected"):
        fresh.load_state_dict({**tsd, "acc.nope": tsd["acc.tp"]})
    with pytest.raises(KeyError, match="Missing"):
        fresh.load_state_dict({k: v for k, v in tsd.items() if k != "cm.confmat"})


def test_clone_is_independent_and_renames():
    tcol = MetricCollection(_flagship("torch"))
    batches = _batches(seed=10)
    tcol.update(*_to("torch", batches[0]))
    twin = tcol.clone(prefix="twin_")
    assert list(twin.keys()) == ["twin_accuracy", "twin_confmat", "twin_f1"]
    assert twin.compute_groups == tcol.compute_groups
    twin.update(*_to("torch", batches[1]))
    assert int(tcol["confmat"].confmat.sum()) == 64 and int(twin["confmat"].confmat.sum()) == 128
    with pytest.raises(ValueError, match="string"):
        tcol.clone(postfix=3)


def test_functional_api_matches_jax():
    """Groups form in one eager update; then ``init_state`` holds one state per
    leader, and ``update_state`` / ``compute_from`` / ``merge_states`` follow JAX."""
    jcol, tcol = JaxCollection(_six("jax")), MetricCollection(_six("torch"))
    assert sorted(tcol.init_state()) == sorted(jcol.init_state()) == sorted(_six("torch"))
    batches = _batches(seed=11, n_batches=4)
    jcol.update(*_to("jax", batches[0]))
    tcol.update(*_to("torch", batches[0]))
    js, ts = jcol.init_state(), tcol.init_state()
    assert sorted(ts) == sorted(js) == ["acc", "cm"]
    for batch in batches[1:]:
        js, ts = jcol.update_state(js, *_to("jax", batch)), tcol.update_state(ts, *_to("torch", batch))
    for name in js:
        assert sorted(ts[name]) == sorted(js[name])
        for key in js[name]:
            _close(ts[name][key], js[name][key])
    _assert_values_equal(tcol.compute_from(ts), jcol.compute_from(js))
    jb = jcol.update_state(jcol.init_state(), *_to("jax", batches[0]))
    tb = tcol.update_state(tcol.init_state(), *_to("torch", batches[0]))
    _assert_values_equal(tcol.compute_from(tcol.merge_states(ts, tb)), jcol.compute_from(jcol.merge_states(js, jb)))
    # compute_from(axis_name=...) syncs each member's state first: in a world of
    # one, the JAX package's compute_from inside shard_map on one device
    want = jax_in_one_device_mesh(lambda s: jcol.compute_from(s, axis_name="dp"), js)
    with world_of_one() as group:
        _assert_values_equal(tcol.compute_from(ts, axis_name=group), want)
        synced = tcol.sync_state(ts, group)
    assert sorted(synced) == ["acc", "cm"] and all(torch.equal(synced[n][k], ts[n][k]) for n in ts for k in ts[n])


def test_reset_forms_the_groups_anew():
    tcol = MetricCollection(_six("torch"))
    tcol.update(*_to("torch", _batches(seed=12, n_batches=1)[0]))
    assert len(tcol.compute_groups) == 2
    tcol.reset()
    assert tcol.compute_groups == {0: ["acc"], 1: ["cm"], 2: ["f1"], 3: ["prec", "rec", "spec"]}
    assert all(m.update_count == 0 for m in tcol.values())


def _samplewise(side):
    cls, _, _, kw = _pkg(side)
    return {"acc": cls.MulticlassAccuracy(C, multidim_average="samplewise", **kw),
            "prec": cls.MulticlassPrecision(C, multidim_average="samplewise", **kw)}


def _samplewise_batches(seed, n_batches):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, C, (4, 9)), rng.integers(0, C, (4, 9))) for _ in range(n_batches)]


def test_list_states_are_shared_by_the_leader_and_copied_when_groups_change():
    """A group's members alias the leader's list ("cat") states and only the
    leader appends; ``add_metrics`` on a live collection and ``clone`` copy the
    lists, so no list is appended to twice."""
    jcol, tcol = JaxCollection(_samplewise("jax")), MetricCollection(_samplewise("torch"))
    assert tcol.compute_groups == jcol.compute_groups == {0: ["acc", "prec"]}
    batches = _samplewise_batches(seed=13, n_batches=5)
    for batch in batches[:2]:
        jcol.update(*_to("jax", batch))
        tcol.update(*_to("torch", batch))
    leader, member = tcol._modules["acc"], tcol._modules["prec"]
    tcol._compute_groups_create_state_ref(copy=False)
    assert member.tp is leader.tp and len(leader.tp) == 2
    twin = tcol.clone()
    assert twin._modules["acc"].tp is not leader.tp
    twin.update(*_to("torch", batches[2]))
    assert len(leader.tp) == 2 and len(twin._modules["acc"].tp) == 3
    jcol.add_metrics({"rec": jax_cls.MulticlassRecall(C, multidim_average="samplewise")})
    tcol.add_metrics({"rec": torch_cls.MulticlassRecall(C, multidim_average="samplewise", device="cpu")})
    assert member.tp is not leader.tp  # the live aliasing was broken before the groups were formed anew
    for batch in batches[2:]:
        jcol.update(*_to("jax", batch))
        tcol.update(*_to("torch", batch))
        assert tcol.compute_groups == jcol.compute_groups
        _assert_states_equal(jcol, tcol)
    assert len(tcol["acc"].tp) == len(tcol["prec"].tp) == 5
    _assert_values_equal(tcol.compute(), jcol.compute())


def test_items_copy_the_leaders_state_and_update_restores_the_aliasing():
    tcol = MetricCollection(_six("torch"))
    batches = _batches(seed=14)
    tcol.update(*_to("torch", batches[0]))
    leader = tcol._modules["acc"]
    member = tcol["prec"]  # copy_state=True: the member gets its own copy
    assert member.tp is not leader.tp and torch.equal(member.tp, leader.tp)
    tcol.update(*_to("torch", batches[1]))
    assert tcol._modules["prec"].tp is leader.tp


def test_equal_metric_states_uses_allclose_and_never_groups_on_a_guess():
    a, b = torch_agg.SumMetric(device="cpu"), torch_agg.SumMetric(device="cpu")
    a.update(torch.tensor(1.0))
    b.update(torch.tensor(1.0 + 1e-7))
    assert MetricCollection._equal_metric_states(a, b)  # within np.allclose's rtol
    b.update(torch.tensor(0.5))
    assert not MetricCollection._equal_metric_states(a, b)
    a.sum_value = b.sum_value = torch.tensor(float("nan"))
    assert not MetricCollection._equal_metric_states(a, b)  # NaN is unequal, as in np.allclose
    a.sum_value, b.sum_value = torch.tensor(1.0), torch.tensor(1.0, dtype=torch.float64)
    assert not MetricCollection._equal_metric_states(a, b)  # dtypes differ
    c, d = torch_agg.CatMetric(device="cpu"), torch_agg.CatMetric(device="cpu")
    assert not MetricCollection._equal_metric_states(a, c)  # other state names
    c.update(torch.tensor([1.0, 2.0]))
    d.update(torch.tensor([1.0, 2.0]))
    assert MetricCollection._equal_metric_states(c, d)
    d.update(torch.tensor([3.0]))
    assert not MetricCollection._equal_metric_states(c, d)  # list lengths differ


def test_structural_test_compares_tensor_config_and_the_device():
    """Curve metrics hold their thresholds as a tensor: equal thresholds seed a
    group (as in the JAX package), other thresholds do not; other devices never."""
    def curves(side, thresholds_b):
        cls, _, coll, kw = _pkg(side)
        return coll({"prc": cls.BinaryPrecisionRecallCurve(thresholds=5, **kw),
                     "roc": cls.BinaryROC(thresholds=5, **kw),
                     "roc_b": cls.BinaryROC(thresholds=thresholds_b, **kw)})

    for thresholds_b in (5, [0.0, 0.5, 1.0]):
        assert curves("torch", thresholds_b).compute_groups == curves("jax", thresholds_b).compute_groups
    assert curves("torch", 5).compute_groups == {0: ["prc", "roc", "roc_b"]}
    cpu_a = torch_cls.MulticlassRecall(C, device="cpu")
    cpu_b = torch_cls.MulticlassRecall(C, device="cpu")
    assert MetricCollection._structurally_identical(cpu_a, cpu_b)
    cpu_b._device = torch.device("meta")
    assert not MetricCollection._structurally_identical(cpu_a, cpu_b)


def test_bad_inputs_raise_like_jax():
    with pytest.raises(ValueError, match="not a instance of"):
        MetricCollection([torch_agg.MeanMetric(device="cpu"), 3])
    with pytest.raises(ValueError, match="not an instance of"):
        MetricCollection({"a": 3})
    with pytest.raises(ValueError, match="not compatible"):
        MetricCollection({"a": torch_agg.MeanMetric(device="cpu")}, torch_agg.SumMetric(device="cpu"))
    with pytest.warns(UserWarning, match="not `Metric`"):
        MetricCollection([torch_agg.MeanMetric(device="cpu")], 3)


def test_docstring_example():
    import doctest

    import metrics_tpu_torch.collections as collections_module

    result = doctest.testmod(collections_module, verbose=False)
    assert result.failed == 0 and result.attempted > 0
