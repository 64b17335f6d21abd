"""The port's ``save``/``restore`` (``metrics_tpu_torch/ckpt/restore.py``,
``Metric.save``/``restore``, ``MetricCollection.save``/``restore``) against the
JAX package's.

One counterpart for each test of ``tests/ckpt/test_restore.py``, run on the port.
Two of them serve a metric the port does not have yet (the wrappers come with
ROADMAP A.10): the wrapper's child metric is a compositional metric's operands
here, and the tracker's module-level ``ckpt.save``/``ckpt.restore`` run on a
collection of compositions. ``PearsonCorrCoef`` (not ported) gives way to
``MeanSquaredError`` as the wrong class. Then the cross-reads: a snapshot saved by
either package restores in the other with equal states (int32 counts bit for bit,
with their dtype) and an equal ``compute()``, and each fault raises the error
type of the same name in both packages.
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
from metrics_tpu_torch.regression import MeanSquaredError

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
    def test_wrong_metric_class_missing_keys(self, data, tmp_path):
        probs, target = data
        path = str(tmp_path / "m.ckpt")
        m = MulticlassAccuracy(5, **CPU)
        m.update(probs, target)
        m.save(path)
        wrong = MeanSquaredError(**CPU)
        with pytest.raises((ckpt.CkptSchemaError, KeyError)):
            wrong.restore(path)
        assert wrong._update_count == 0
        assert int(wrong.total) == 0

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
