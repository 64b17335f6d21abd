"""The port's ``save``/``restore`` (``metrics_tpu_torch/ckpt/restore.py``,
``Metric.save``/``restore``, ``MetricCollection.save``/``restore``) against the
JAX package's.

One counterpart for each test of ``tests/ckpt/test_restore.py``, run on the port,
the wrappers' included (``MinMaxMetric``'s extremes, ``MetricTracker``'s
history through the module-level ``ckpt.save``/``ckpt.restore``); the two
stand-ins written before the wrappers were ported (a compositional metric's
operands as child metrics, a collection of compositions) stay. The wrong class of the strict-validation test is
``PearsonCorrCoef``, as in the JAX test, and ``MeanSquaredError`` too. Then the
cross-reads: a snapshot saved by either package (``R2Score``'s among them)
restores in the other with equal states (int32 counts bit for bit, with their
dtype) and an equal ``compute()``, the wrappers' snapshots too (``BootStrapper``
stacked, after its fall-back to copies, and with Poisson copies, each resuming
with the other package's generator state; ``MinMaxMetric``; ``MetricTracker``),
and each fault raises the error type of the same name in both packages.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.ckpt as jax_ckpt
import metrics_tpu.classification as jcls
import metrics_tpu_torch as tm
import metrics_tpu_torch.classification as tcls
from metrics_tpu_torch import ckpt
from metrics_tpu_torch.comm import CodecPolicy
from metrics_tpu_torch.classification import (
    BinaryPrecisionRecallCurve,
    MulticlassAccuracy,
    MulticlassF1Score,
    MulticlassPrecision,
    MulticlassRecall,
)
from metrics_tpu_torch.regression import MeanSquaredError, PearsonCorrCoef

CPU = {"device": "cpu"}


@pytest.fixture
def data():
    rng = np.random.default_rng(0)
    probs = rng.random((48, 5)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    return torch.from_numpy(probs), torch.from_numpy(rng.integers(0, 5, 48))


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _tree_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _grouped():
    return tm.MetricCollection(
        [MulticlassPrecision(5, **CPU), MulticlassRecall(5, **CPU), MulticlassF1Score(5, **CPU)],
        compute_groups=True,
    )


# --------------------------------------------------------------------------- tests/ckpt/test_restore.py


class TestRoundTrip:
    def test_metric_bit_identical_and_resumable(self, data, tmp_path):
        probs, target = data
        path = str(tmp_path / "m.ckpt")
        m = MulticlassAccuracy(5, average="macro", **CPU)
        m.update(probs[:30], target[:30])
        m.save(path)
        m2 = MulticlassAccuracy(5, average="macro", **CPU)
        m2.restore(path)
        assert m2._update_count == m._update_count
        assert torch.equal(m2.compute(), m.compute())
        m.update(probs[30:], target[30:])
        m2.update(probs[30:], target[30:])
        assert torch.equal(m2.compute(), m.compute())

    def test_save_captures_full_state_without_persistent_flags(self, data, tmp_path):
        probs, target = data
        path = str(tmp_path / "m.ckpt")
        m = MulticlassAccuracy(5, average="micro", **CPU)
        m.update(probs, target)
        assert m.state_dict() == {}
        m.save(path)
        assert m.state_dict() == {}
        m2 = MulticlassAccuracy(5, average="micro", **CPU)
        m2.restore(path)
        assert float(m2.compute()) == float(m.compute())

    def test_cat_state_metric(self, data, tmp_path):
        probs, target = data
        path = str(tmp_path / "curve.ckpt")
        c = BinaryPrecisionRecallCurve(thresholds=None, **CPU)
        c.update(probs[:, 0], (target == 0).to(torch.int32))
        c.save(path)
        c2 = BinaryPrecisionRecallCurve(thresholds=None, **CPU)
        c2.restore(path)
        _tree_equal(list(c2.compute()), list(c.compute()))

    def test_child_metrics_round_trip(self, data, tmp_path):
        """The wrapper test's counterpart: a compositional metric's operands are
        child metrics, saved and restored under their prefixes."""
        probs, target = data
        path = str(tmp_path / "comp.ckpt")
        comp = MulticlassPrecision(5, **CPU) + MulticlassRecall(5, **CPU)
        comp.update(probs[:16], target[:16])
        comp.compute()
        comp.update(probs[16:], target[16:])
        comp.save(path)
        fresh = MulticlassPrecision(5, **CPU) + MulticlassRecall(5, **CPU)
        fresh.restore(path)
        _tree_equal(fresh.compute(), comp.compute())

    def test_module_level_save_restore_of_a_collection(self, data, tmp_path):
        """The tracker test's counterpart: ``ckpt.save``/``ckpt.restore`` on a
        collection whose members hold child metrics."""
        probs, target = data
        path = str(tmp_path / "col.ckpt")

        def make():
            return tm.MetricCollection({"acc": MulticlassAccuracy(5, average="micro", **CPU),
                                        "pr": MulticlassPrecision(5, **CPU) + MulticlassRecall(5, **CPU)})

        col = make()
        for lo in (0, 24):
            col.update(probs[lo : lo + 24], target[lo : lo + 24])
        ckpt.save(col, path)
        fresh = make()
        ckpt.restore(fresh, path)
        _tree_equal(fresh.compute(), col.compute())

    def test_wrapper_extras_round_trip(self, data, tmp_path):
        probs, target = data
        path = str(tmp_path / "mm.ckpt")
        w = tm.MinMaxMetric(MulticlassAccuracy(5, average="micro", **CPU))
        w.update(probs[:16], target[:16])
        w.compute()
        w.update(probs[16:], target[16:])
        w.save(path)
        w2 = tm.MinMaxMetric(MulticlassAccuracy(5, average="micro", **CPU))
        w2.restore(path)
        _tree_equal(w2.compute(), w.compute())

    def test_tracker_dynamic_history(self, data, tmp_path):
        probs, target = data
        path = str(tmp_path / "tr.ckpt")
        tr = tm.MetricTracker(MulticlassAccuracy(5, average="micro", **CPU))
        for lo in (0, 24):
            tr.increment()
            tr.update(probs[lo : lo + 24], target[lo : lo + 24])
        ckpt.save(tr, path)
        fresh = tm.MetricTracker(MulticlassAccuracy(5, average="micro", **CPU))
        ckpt.restore(fresh, path)
        assert fresh.n_steps == 2
        _tree_equal(fresh.compute_all(), tr.compute_all())

    def test_lossy_policy_bounded_not_identical(self, tmp_path):
        path = str(tmp_path / "cat.ckpt")
        m = tm.CatMetric(**CPU)
        big = np.random.default_rng(1).standard_normal(8192).astype(np.float32)
        m.update(torch.from_numpy(big))
        ckpt.save(m, path, policy=CodecPolicy(lossy="int8"))
        m2 = tm.CatMetric(**CPU)
        m2.restore(path)
        got = m2.compute().numpy()
        assert not np.array_equal(got, big)
        assert np.max(np.abs(got - big)) < np.abs(big).max() / 100


class TestComputeGroupAliasing:
    def test_restore_into_fresh_collection(self, data, tmp_path):
        probs, target = data
        path = str(tmp_path / "col.ckpt")
        col = _grouped()
        col.update(probs, target)
        assert len(col.compute_groups) == 1
        col.save(path)
        fresh = _grouped()
        fresh.restore(path)
        _tree_equal(fresh.compute(), col.compute())
        col.update(probs[:10], target[:10])
        fresh.update(probs[:10], target[:10])
        _tree_equal(fresh.compute(), col.compute())

    def test_restore_over_live_collection_drops_stale_state(self, data, tmp_path):
        probs, target = data
        path = str(tmp_path / "col.ckpt")
        col = _grouped()
        col.update(probs[:20], target[:20])
        expected = col.compute()
        col.save(path)
        col.update(probs[20:], target[20:])
        advanced = col.compute()
        assert not all(torch.equal(expected[k], advanced[k]) for k in expected)
        col.restore(path)
        _tree_equal(col.compute(), expected)
        for name, member in col.items(copy_state=False):
            assert member._computed is None or torch.equal(member.compute(), expected[name])

    def test_members_alias_leader_arrays_after_restore(self, data, tmp_path):
        probs, target = data
        path = str(tmp_path / "col.ckpt")
        col = _grouped()
        col.update(probs, target)
        col.save(path)
        col.restore(path)
        group = next(iter(col.compute_groups.values()))
        leader = col._modules[group[0]]
        for name in group[1:]:
            member = col._modules[name]
            for state in leader._defaults:
                assert getattr(member, state) is getattr(leader, state), name


class TestStrictValidation:
    @pytest.mark.parametrize("wrong_class,count_state", [(PearsonCorrCoef, "n_total"), (MeanSquaredError, "total")],
                             ids=["PearsonCorrCoef", "MeanSquaredError"])
    def test_wrong_metric_class_missing_keys(self, data, tmp_path, wrong_class, count_state):
        probs, target = data
        path = str(tmp_path / "m.ckpt")
        m = MulticlassAccuracy(5, **CPU)
        m.update(probs, target)
        m.save(path)
        wrong = wrong_class(**CPU)
        with pytest.raises((ckpt.CkptSchemaError, KeyError)):
            wrong.restore(path)
        # the failed restore left the instance untouched
        assert wrong._update_count == 0
        assert float(getattr(wrong, count_state)) == 0

    def test_shape_mismatch_raises_schema_error(self, data, tmp_path):
        probs, target = data
        path = str(tmp_path / "m.ckpt")
        m = MulticlassAccuracy(5, **CPU)
        m.update(probs, target)
        m.save(path)
        with pytest.raises(ckpt.CkptSchemaError, match="shape"):
            MulticlassAccuracy(7, **CPU).restore(path)

    def test_dtype_mismatch_raises_schema_error(self, tmp_path):
        path = str(tmp_path / "m.ckpt")
        m = MeanSquaredError(**CPU)
        m.update(torch.tensor([1.0, 2.0]), torch.tensor([1.0, 1.0]))
        m.save(path)
        other = MeanSquaredError(**CPU).set_dtype(torch.float16)
        with pytest.raises(ckpt.CkptSchemaError, match="dtype"):
            other.restore(path)

    def test_collection_vs_metric_kind_mismatch(self, data, tmp_path):
        probs, target = data
        path = str(tmp_path / "m.ckpt")
        m = MulticlassAccuracy(5, **CPU)
        m.update(probs, target)
        m.save(path)
        with pytest.raises(ckpt.CkptSchemaError, match="kind|holds"):
            tm.MetricCollection([MulticlassAccuracy(5, **CPU)]).restore(path)

    def test_corrupt_file_raises_corrupt_error(self, data, tmp_path):
        probs, target = data
        path = str(tmp_path / "m.ckpt")
        m = MulticlassAccuracy(5, **CPU)
        m.update(probs, target)
        m.save(path)
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            f.write(b"\x00\x01\x02")
        with pytest.raises(ckpt.CorruptSnapshotError):
            MulticlassAccuracy(5, **CPU).restore(path)


class TestMigrations:
    @pytest.fixture(autouse=True)
    def _clean_registry(self):
        ckpt.clear_migrations()
        yield
        ckpt.clear_migrations()

    def _old_snapshot(self, path, data):
        """Write a v0 snapshot whose state_dict uses a legacy key name."""
        from metrics_tpu_torch.ckpt.restore import _build_tree

        probs, target = data
        m = MulticlassAccuracy(5, **CPU)
        m.update(probs, target)
        tree, _ = _build_tree(m)
        sd = tree["state_dict"]
        sd["true_positives"] = sd.pop("tp")
        with open(path, "wb") as f:
            f.write(ckpt.dumps(tree, schema_version=0, meta={"v": "old"}))
        return m

    def test_migration_hook_bridges_old_schema(self, data, tmp_path):
        path = str(tmp_path / "old.ckpt")
        original = self._old_snapshot(path, data)

        def to_v1(tree, meta):
            sd = dict(tree["state_dict"])
            sd["tp"] = sd.pop("true_positives")
            return {**tree, "state_dict": sd}

        ckpt.register_migration(0, to_v1)
        fresh = MulticlassAccuracy(5, **CPU)
        fresh.restore(path)
        assert float(fresh.compute()) == float(original.compute())

    def test_missing_migration_refuses(self, data, tmp_path):
        path = str(tmp_path / "old.ckpt")
        self._old_snapshot(path, data)
        with pytest.raises(ckpt.CkptSchemaError, match="migration"):
            MulticlassAccuracy(5, **CPU).restore(path)

    def test_newer_schema_refuses(self, data, tmp_path):
        from metrics_tpu_torch.ckpt.restore import _build_tree

        probs, target = data
        path = str(tmp_path / "future.ckpt")
        m = MulticlassAccuracy(5, **CPU)
        m.update(probs, target)
        tree, _ = _build_tree(m)
        with open(path, "wb") as f:
            f.write(ckpt.dumps(tree, schema_version=ckpt.CKPT_SCHEMA_VERSION + 1))
        with pytest.raises(ckpt.CkptSchemaError, match="NEWER"):
            MulticlassAccuracy(5, **CPU).restore(path)

    def test_duplicate_registration_raises(self):
        ckpt.register_migration(0, lambda t, m: t)
        with pytest.raises(ValueError, match="already registered"):
            ckpt.register_migration(0, lambda t, m: t)


# --------------------------------------------------------------------------- the two packages


def _flagship(pkg, **kw):
    return pkg.MetricCollection({
        "accuracy": pkg.classification.MulticlassAccuracy(5, average="micro", **kw),
        "f1": pkg.classification.MulticlassF1Score(5, average="macro", **kw),
        "confmat": pkg.classification.MulticlassConfusionMatrix(5, **kw),
    })


# name -> (JAX metric, port metric, update inputs from an rng)
CASES = {
    "multiclass_accuracy": (lambda: jcls.MulticlassAccuracy(5, average="macro"),
                            lambda: tcls.MulticlassAccuracy(5, average="macro", **CPU),
                            lambda rng: (rng.integers(0, 5, 40).astype(np.int32), rng.integers(0, 5, 40).astype(np.int32))),
    "binary_accuracy": (lambda: jcls.BinaryAccuracy(), lambda: tcls.BinaryAccuracy(**CPU),
                        lambda rng: (rng.random(40).astype(np.float32), rng.integers(0, 2, 40).astype(np.int32))),
    "mse": (lambda: jm.MeanSquaredError(), lambda: tm.MeanSquaredError(**CPU),
            lambda rng: (rng.normal(size=40).astype(np.float32), rng.normal(size=40).astype(np.float32))),
    "cat": (lambda: jm.CatMetric(), lambda: tm.CatMetric(**CPU), lambda rng: (rng.random(7).astype(np.float32),)),
    "r2": (lambda: jm.R2Score(adjusted=1), lambda: tm.R2Score(adjusted=1, **CPU),
           lambda rng: (rng.normal(size=40).astype(np.float32), rng.normal(size=40).astype(np.float32))),
    "flagship_collection": (lambda: _flagship(jm), lambda: _flagship(tm, **CPU),
                            lambda rng: (rng.integers(0, 5, 40).astype(np.int32),
                                         rng.integers(0, 5, 40).astype(np.int32))),
}


def _values(x):
    if isinstance(x, dict):
        return {k: _values(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _states(obj):
    """Every registered state of a metric or collection, as numpy, by prefix."""
    out = {}
    members = obj._modules.items() if isinstance(obj, (tm.MetricCollection, jm.MetricCollection)) else [("", obj)]
    for name, m in members:
        for state in m._defaults:
            val = getattr(m, state)
            vals = val if isinstance(val, list) else [val]
            for i, v in enumerate(vals):
                out[f"{name}.{state}.{i}"] = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        out[f"{name}._update_count"] = np.asarray(m._update_count)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_save_of_either_package_restores_in_the_other(case, writer, tmp_path):
    make_jax, make_port, gen = CASES[case]
    rng = np.random.default_rng(11)
    batches = [gen(rng) for _ in range(3)]
    jax_m, port_m = make_jax(), make_port()
    for args in batches:
        jax_m.update(*map(jnp.asarray, args))
        port_m.update(*map(torch.from_numpy, args))
    path = str(tmp_path / "m.ckpt")
    (jax_m if writer == "jax" else port_m).save(path, meta={"writer": writer})
    fresh_jax, fresh_port = make_jax(), make_port()
    fresh_jax.restore(path)
    snap = fresh_port.restore(path)
    assert snap.meta["writer"] == writer
    got, want = _states(fresh_port), _states(fresh_jax)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _tree_equal(_values(fresh_port.compute()), _values(fresh_jax.compute()))


class _JItemSum(jm.Metric):
    def __init__(self):
        super().__init__()
        self.add_state("total", jnp.zeros(()), dist_reduce_fx="sum")

    def update(self, x):
        if float(jnp.sum(x)) >= -1e30:
            self.total = self.total + jnp.sum(x)

    def compute(self):
        return self.total


class _TItemSum(tm.Metric):
    def __init__(self):
        super().__init__(**CPU)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x):
        if float(torch.sum(x)) >= -1e30:
            self.total = self.total + torch.sum(x)

    def compute(self):
        return self.total


def _labels5(rng):
    return rng.integers(0, 5, 40).astype(np.int32), rng.integers(0, 5, 40).astype(np.int32)


# name -> (JAX wrapper, port wrapper, update inputs from an rng)
WRAPPER_CASES = {
    "bootstrap_stacked": (
        lambda: jm.BootStrapper(jcls.MulticlassConfusionMatrix(5), 4, sampling_strategy="multinomial", seed=1, raw=True),
        lambda: tm.BootStrapper(tcls.MulticlassConfusionMatrix(5, **CPU), 4, sampling_strategy="multinomial", seed=1,
                                raw=True),
        _labels5),
    "bootstrap_poisson": (
        lambda: jm.BootStrapper(jcls.MulticlassAccuracy(5, average="micro"), 3, seed=2, raw=True),
        lambda: tm.BootStrapper(tcls.MulticlassAccuracy(5, average="micro", **CPU), 3, seed=2, raw=True),
        _labels5),
    "bootstrap_fallen_back": (
        lambda: jm.BootStrapper(_JItemSum(), 3, sampling_strategy="multinomial", seed=3, raw=True),
        lambda: tm.BootStrapper(_TItemSum(), 3, sampling_strategy="multinomial", seed=3, raw=True),
        lambda rng: (rng.normal(size=40).astype(np.float32),)),
    "minmax": (lambda: jm.MinMaxMetric(jcls.MulticlassF1Score(5)), lambda: tm.MinMaxMetric(tcls.MulticlassF1Score(5, **CPU)),
               _labels5),
}


@pytest.mark.parametrize("case", sorted(WRAPPER_CASES))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_wrapper_save_of_either_package_restores_in_the_other(case, writer, tmp_path):
    """A wrapper saved by one package restores in the other, and after one
    more batch it computes what the writer's own instance computes: a
    bootstrapper's generator state crossed with its states (so both draw the
    same rows), in its mode."""
    make_jax, make_port, gen = WRAPPER_CASES[case]
    rng = np.random.default_rng(5)
    jax_m, port_m = make_jax(), make_port()
    for _ in range(2):
        args = gen(rng)
        jax_m.update(*map(jnp.asarray, args))
        port_m.update(*map(torch.from_numpy, args))
        jax_m.compute()
        port_m.compute()
    path = str(tmp_path / "w.ckpt")
    writer_m = jax_m if writer == "jax" else port_m
    writer_m.save(path)
    reader = make_port() if writer == "jax" else make_jax()
    reader.restore(path)
    if case.startswith("bootstrap"):
        assert reader._use_vmap == writer_m._use_vmap == (case == "bootstrap_stacked")
    args = gen(rng)
    for m in (writer_m, reader):
        m.update(*map(jnp.asarray if isinstance(m, jm.Metric) else torch.from_numpy, args))
    want, got = _values(writer_m.compute()), _values(reader.compute())
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_a_bootstrapper_snapshot_names_its_text_leaf_so_both_packages_parse_it_c15(tmp_path):
    """ROADMAP C.15: the JAX package names a text leaf's dtype by numpy's
    ``dtype.name`` (``str352``), which its own reader cannot parse, so a JAX
    ``BootStrapper`` snapshot does not restore in the JAX package. The port
    names it ``<U11`` and reads both names."""
    make_jax, make_port, gen = WRAPPER_CASES["bootstrap_stacked"]
    path_j, path_p = str(tmp_path / "j.ckpt"), str(tmp_path / "p.ckpt")
    make_jax().save(path_j)
    make_port().save(path_p)
    with pytest.raises(AttributeError, match="str352"):
        make_jax().restore(path_j)
    make_jax().restore(path_p)
    make_port().restore(path_j)
    make_port().restore(path_p)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_tracker_save_of_either_package_restores_in_the_other(writer, tmp_path):
    def make(pkg, **kw):
        return pkg.MetricTracker(pkg.MetricCollection({
            "accuracy": pkg.classification.MulticlassAccuracy(5, average="micro", **kw),
            "f1": pkg.classification.MulticlassF1Score(5, average="macro", **kw)}), maximize=[True, False])

    rng = np.random.default_rng(6)
    jt, pt = make(jm), make(tm, **CPU)
    for _ in range(3):
        jt.increment()
        pt.increment()
        args = _labels5(rng)
        jt.update(*map(jnp.asarray, args))
        pt.update(*map(torch.from_numpy, args))
    path = str(tmp_path / "tr.ckpt")
    (jax_ckpt if writer == "jax" else ckpt).save(jt if writer == "jax" else pt, path)
    fresh_jax, fresh_port = make(jm), make(tm, **CPU)
    jax_ckpt.restore(fresh_jax, path)
    ckpt.restore(fresh_port, path)
    assert fresh_port.n_steps == fresh_jax.n_steps == 3
    _tree_equal(_values(fresh_port.compute_all()), _values(fresh_jax.compute_all()))
    assert fresh_port.best_metric(return_step=True)[1] == fresh_jax.best_metric(return_step=True)[1]


def _corrupt(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        f.write(b"\x00\x01\x02")


def _future(path):
    from metrics_tpu.ckpt.restore import _build_tree

    m = jcls.MulticlassAccuracy(5)
    m.update(jnp.asarray([1, 2]), jnp.asarray([1, 3]))
    tree, _ = _build_tree(m)
    with open(path, "wb") as f:
        f.write(jax_ckpt.dumps(tree, schema_version=jax_ckpt.CKPT_SCHEMA_VERSION + 1))


# fault -> (how the file is spoiled after a JAX save of MulticlassAccuracy(5), the metric restored, error name)
FAULTS = {
    "corrupt": (_corrupt, lambda pkg, **kw: pkg.classification.MulticlassAccuracy(5, **kw), "CorruptSnapshotError"),
    "torn": (lambda p: open(p, "r+b").truncate(40), lambda pkg, **kw: pkg.classification.MulticlassAccuracy(5, **kw),
             "CorruptSnapshotError"),
    "shape": (lambda p: None, lambda pkg, **kw: pkg.classification.MulticlassAccuracy(7, **kw), "CkptSchemaError"),
    "kind": (lambda p: None, lambda pkg, **kw: pkg.MetricCollection([pkg.classification.MulticlassAccuracy(5, **kw)]),
             "CkptSchemaError"),
    "newer_schema": (_future, lambda pkg, **kw: pkg.classification.MulticlassAccuracy(5, **kw), "CkptSchemaError"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults_raise_the_jax_error_types(fault, tmp_path):
    spoil, make, error = FAULTS[fault]
    path = str(tmp_path / "m.ckpt")
    m = jcls.MulticlassAccuracy(5)
    m.update(jnp.asarray([1, 2, 3]), jnp.asarray([1, 3, 3]))
    m.save(path)
    spoil(path)
    with pytest.raises(Exception) as jax_err:
        make(jm).restore(path)
    port_metric = make(tm, **CPU)
    with pytest.raises(getattr(ckpt, error)) as port_err:
        port_metric.restore(path)
    assert type(jax_err.value).__name__ == type(port_err.value).__name__ == error
    members = port_metric._modules.values() if isinstance(port_metric, tm.MetricCollection) else [port_metric]
    assert all(m._update_count == 0 for m in members)  # the failed restore left the instance untouched


def _jax_flatten8(imgs):
    return jnp.asarray(imgs).reshape(imgs.shape[0], -1)[:, :8].astype(jnp.float32)


def _port_flatten8(imgs):
    return imgs.reshape(imgs.shape[0], -1)[:, :8].to(torch.float32)


# name -> (JAX metric, port metric): a feature callable of 8 pixels, as the JAX image tests use
IMAGE_CASES = {
    "fid": (lambda: jm.image.FrechetInceptionDistance(_jax_flatten8, num_features=8, sqrtm_backend="newton"),
            lambda: tm.image.FrechetInceptionDistance(_port_flatten8, num_features=8, sqrtm_backend="newton", **CPU)),
    "kid": (lambda: jm.image.KernelInceptionDistance(_jax_flatten8, subsets=3, subset_size=10),
            lambda: tm.image.KernelInceptionDistance(_port_flatten8, subsets=3, subset_size=10, **CPU)),
}


@pytest.mark.parametrize("case", sorted(IMAGE_CASES))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_an_fid_or_kid_save_of_either_package_restores_in_the_other(case, writer, tmp_path):
    """FID's float32 sums and int32 counts, and KID's list states, saved by
    one package restore in the other with equal states and equal values (KID
    under one ``np.random.seed``)."""
    make_jax, make_port = IMAGE_CASES[case]
    rng = np.random.default_rng(13)
    jax_m, port_m = make_jax(), make_port()
    for real in (True, False, True, False):
        imgs = rng.random((12, 3, 4, 4)).astype(np.float32) + (0.0 if real else 0.3)
        jax_m.update(jnp.asarray(imgs), real=real)
        port_m.update(torch.from_numpy(imgs), real=real)
    path = str(tmp_path / "image.ckpt")
    (jax_m if writer == "jax" else port_m).save(path)
    fresh_jax, fresh_port = make_jax(), make_port()
    fresh_jax.restore(path)
    fresh_port.restore(path)
    got, want = _states(fresh_port), _states(fresh_jax)
    assert got.keys() == want.keys() and len(got) > 3
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.random.seed(3)
    want_v = _values(fresh_jax.compute())
    np.random.seed(3)
    got_v = _values(fresh_port.compute())
    np.testing.assert_allclose(np.atleast_1d(got_v), np.atleast_1d(want_v), rtol=1e-4, atol=1e-6)
