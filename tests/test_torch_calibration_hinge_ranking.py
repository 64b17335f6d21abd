"""The port's calibration error, hinge loss and multilabel ranking metrics
(functionals, modules and task façades) against the JAX package's, on the CPU.

The same seeded numpy batches go through both packages: float32, float64 and
float16 scores, probabilities and logits (through the sigmoid or softmax),
int32 and int64 labels, ``ignore_index`` None, -1 and an in-range value;
calibration's three norms and confidences placed exactly on the bin edges of
``jnp.linspace(0, 1, n_bins + 1)``; both hinge modes, squared or not; ranking
scores with ties. Float outputs are held within a tolerance stated by dtype
(``TOL``): float32 sums (the per-bin matrix products, the hinge and ranking
sums, softmax and sigmoid, whose CPU results differ by up to 2 ulp between
the stacks) taken in another order, and for float16 functionals (which
compute in float16 in both packages) float16 sums. Bin counts are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jax_top
import metrics_tpu.classification as jax_cls
import metrics_tpu.functional.classification as jax_fn
import metrics_tpu_torch as torch_top
import metrics_tpu_torch.classification as torch_cls
import metrics_tpu_torch.functional.classification as torch_fn
from metrics_tpu_torch.functional.classification.precision_recall_curve import _linspace01

CPU = {"device": "cpu"}
# (rtol, atol) by output dtype: float32 sums in another order; float16 sums of up to N terms
TOL = {"float32": (1e-5, 1e-6), "float16": (1e-2, 2e-3)}
C = 5
N = 64
X = 3
SCORES = ("float32", "float64", "float16")
LABELS = ("int32", "int64")


def seed_of(*parts):
    return sum(map(ord, repr(parts)))


def close(got, want):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w)
        return
    want = np.asarray(want)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype), (got.dtype, want.dtype)
    rtol, atol = TOL[str(want.dtype)]
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), rtol=rtol, atol=atol, equal_nan=True)


def both(batch):
    return tuple(jnp.asarray(b) for b in batch), tuple(torch.from_numpy(np.ascontiguousarray(b)) for b in batch)


def _target(rng, shape, classes, ignore_index, dtype):
    target = rng.integers(0, classes, shape)
    if ignore_index is not None:
        target[rng.random(shape) < 0.2] = ignore_index
    return target.astype(dtype)


def binary_batch(rng, score, label, ignore_index, logits=False, shape=(N,)):
    preds = rng.normal(0.0, 2.0, shape) if logits else rng.random(shape)
    return preds.astype(score), _target(rng, shape, 2, ignore_index, label)


def multiclass_batch(rng, score, label, ignore_index, logits=False, shape=(N,)):
    logit = rng.normal(0.0, 2.0, (*shape, C))
    if logits:
        preds = logit
    else:
        e = np.exp(logit - logit.max(-1, keepdims=True))
        preds = e / e.sum(-1, keepdims=True)
    return np.moveaxis(preds, -1, 1).astype(score), _target(rng, shape, C, ignore_index, label)


def multilabel_batch(rng, score, label, ignore_index, logits=False, shape=(N, C), ties=False):
    if ties:
        preds = rng.integers(0, 4, shape) / 4.0
    else:
        preds = rng.normal(0.0, 2.0, shape) if logits else rng.random(shape)
    return preds.astype(score), _target(rng, shape, 2, ignore_index, label)


def run(fn_name, cls_name, kw, batches, fn_kw=None, states=()):
    """The functional on each batch, ``update`` / ``forward`` alternately, the
    float32 states after every batch, then ``compute`` and ``compute_from``."""
    jfun, tfun = getattr(jax_fn, fn_name), getattr(torch_fn, fn_name)
    jm, tm = getattr(jax_cls, cls_name)(**kw), getattr(torch_cls, cls_name)(**kw, **CPU)
    jstate, tstate = jm.init_state(), tm.init_state()
    fkw = {**kw, **(fn_kw or {})}
    for i, batch in enumerate(batches):
        jb, tb = both(batch)
        close(tfun(*tb, **fkw), jfun(*jb, **fkw))
        if i % 2:
            close(tm.forward(*tb), jm.forward(*jb))
        else:
            jm.update(*jb)
            tm.update(*tb)
        for key in jm._defaults:
            assert getattr(tm, key).dtype == torch.float32
            close(getattr(tm, key), getattr(jm, key))
        jstate, tstate = jm.update_state(jstate, *jb), tm.update_state(tstate, *tb)
    close(tm.compute(), jm.compute())
    close(tm.compute_from(tstate), jm.compute_from(jstate))
    return tm, jm


def _cases(ignores):
    return [(s, l, i, lg) for s in SCORES for l in LABELS for i in ignores for lg in (False, True)]


BIN_CASES = _cases((None, -1, 0))
MC_CASES = _cases((None, -1, 2))


def _id(c):
    return "-".join(map(str, c))


@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
@pytest.mark.parametrize("score,label,ignore,logits", BIN_CASES, ids=[_id(c) for c in BIN_CASES])
def test_binary_calibration_error_matches_jax(score, label, ignore, logits, norm):
    rng = np.random.default_rng(seed_of("bce", score, label, ignore, logits, norm))
    batches = [binary_batch(rng, score, label, ignore, logits) for _ in range(3)]
    tm, jm = run("binary_calibration_error", "BinaryCalibrationError",
                 {"n_bins": 10, "norm": norm, "ignore_index": ignore}, batches)
    np.testing.assert_array_equal(tm.count_bin.numpy(), np.asarray(jm.count_bin))


@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
@pytest.mark.parametrize("score,label,ignore,logits", MC_CASES, ids=[_id(c) for c in MC_CASES])
def test_multiclass_calibration_error_matches_jax(score, label, ignore, logits, norm):
    rng = np.random.default_rng(seed_of("mce", score, label, ignore, logits, norm))
    shape = (N,) if norm != "max" else (N // 4, X)  # (N, C, X) scores as well
    batches = [multiclass_batch(rng, score, label, ignore, logits, shape=shape) for _ in range(3)]
    tm, jm = run("multiclass_calibration_error", "MulticlassCalibrationError",
                 {"num_classes": C, "norm": norm, "ignore_index": ignore}, batches)
    np.testing.assert_array_equal(tm.count_bin.numpy(), np.asarray(jm.count_bin))


@pytest.mark.parametrize("n_bins", [15, 100])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_confidences_on_the_bin_edges_fall_in_the_jax_bins(n_bins, dtype):
    """Every edge of ``jnp.linspace(0, 1, n_bins + 1)`` (``torch.linspace``
    differs from it in the last bit at some), and its neighbours one ulp
    away, land in the JAX package's bins: equal counts, bin by bin."""
    edges = np.asarray(jnp.linspace(0.0, 1.0, n_bins + 1, dtype=dtype))
    assert np.array_equal(_linspace01(n_bins + 1, dtype=getattr(torch, dtype)).numpy(), edges)
    up, down = np.nextafter(edges, np.asarray(2, dtype)), np.nextafter(edges, np.asarray(-1, dtype))
    conf = np.clip(np.concatenate([edges, up, down]), 0, 1).astype(dtype)
    target = (np.arange(conf.size) % 2).astype(np.int32)
    jb, tb = both((conf, target))
    jm = jax_cls.BinaryCalibrationError(n_bins=n_bins)
    tm = torch_cls.BinaryCalibrationError(n_bins=n_bins, **CPU)
    jm.update(*jb)
    tm.update(*tb)
    np.testing.assert_array_equal(tm.count_bin.numpy(), np.asarray(jm.count_bin))
    np.testing.assert_array_equal(tm.acc_bin.numpy(), np.asarray(jm.acc_bin))
    close(tm.compute(), jm.compute())
    close(torch_fn.binary_calibration_error(*tb, n_bins=n_bins), jax_fn.binary_calibration_error(*jb, n_bins=n_bins))


HINGE_CASES = [(task, s, l, i, lg) for task, ignores in (("binary", (None, -1, 0)), ("multiclass", (None, -1, 2)))
               for s in SCORES for l in LABELS for i in ignores for lg in (False, True)]


@pytest.mark.parametrize("task,score,label,ignore,logits", HINGE_CASES, ids=[_id(c) for c in HINGE_CASES])
def test_hinge_loss_matches_jax(task, score, label, ignore, logits):
    rng = np.random.default_rng(seed_of("hinge", task, score, label, ignore, logits))
    make = binary_batch if task == "binary" else multiclass_batch
    batches = [make(rng, score, label, ignore, logits) for _ in range(2)]
    modes = [{}] if task == "binary" else [{"multiclass_mode": "crammer-singer"}, {"multiclass_mode": "one-vs-all"}]
    for squared in (False, True):
        for mode in modes:
            kw = {"squared": squared, "ignore_index": ignore, **mode, **({"num_classes": C} if task != "binary" else {})}
            run(f"{task}_hinge_loss", f"{task.capitalize()}HingeLoss", kw, batches, fn_kw={"validate_args": True})


RANKING = [("multilabel_coverage_error", "MultilabelCoverageError"),
           ("multilabel_ranking_average_precision", "MultilabelRankingAveragePrecision"),
           ("multilabel_ranking_loss", "MultilabelRankingLoss")]
RANK_CASES = [(s, l, i, kind) for s in SCORES for l in LABELS for i in (None, -1, 1)
              for kind in ("probs", "logits", "ties", "extra_dim")]


@pytest.mark.parametrize("score,label,ignore,kind", RANK_CASES, ids=[_id(c) for c in RANK_CASES])
def test_ranking_metrics_match_jax(score, label, ignore, kind):
    rng = np.random.default_rng(seed_of("rank", score, label, ignore, kind))
    shape = (N // 4, C, X) if kind == "extra_dim" else (N, C)
    batches = [multilabel_batch(rng, score, label, ignore, kind == "logits", shape, kind == "ties") for _ in range(2)]
    for fn_name, cls_name in RANKING:
        run(fn_name, cls_name, {"num_labels": C, "ignore_index": ignore}, batches)


def test_ranking_degenerate_samples_like_jax():
    """Samples with no relevant label, every label relevant, and all scores tied."""
    preds = np.array([[0.5] * C, [0.1, 0.9, 0.3, 0.7, 0.2], [0.3] * C, [0.9, 0.8, 0.7, 0.6, 0.5]], np.float32)
    target = np.array([[0] * C, [1] * C, [1, 0, 1, 0, 0], [0, 0, 0, 0, 1]], np.int64)
    jb, tb = both((preds, target))
    for fn_name, _ in RANKING:
        close(getattr(torch_fn, fn_name)(*tb, C), getattr(jax_fn, fn_name)(*jb, C))


FACADES = [("calibration_error", "CalibrationError", {"n_bins": 7}), ("hinge_loss", "HingeLoss", {"squared": True})]


@pytest.mark.parametrize("fn_name,cls_name,extra", FACADES, ids=[f[1] for f in FACADES])
def test_task_facades_match_jax(fn_name, cls_name, extra):
    rng = np.random.default_rng(seed_of(cls_name))
    for task, make in (("binary", binary_batch), ("multiclass", multiclass_batch)):
        jb, tb = both(make(rng, "float32", "int64", -1))
        kw = {"ignore_index": -1, **extra, **({"num_classes": C} if task == "multiclass" else {})}
        close(getattr(torch_fn, fn_name)(*tb, task=task, **kw), getattr(jax_fn, fn_name)(*jb, task=task, **kw))
        jm, tm = getattr(jax_top, cls_name)(task=task, **kw), getattr(torch_top, cls_name)(task=task, **kw, **CPU)
        assert type(tm).__name__ == type(jm).__name__
        jm.update(*jb)
        tm.update(*tb)
        close(tm.compute(), jm.compute())


def _error(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


def _module(pkg, name, xs, *args, **kw):
    m = getattr(pkg, name)(*args, **kw, **({} if pkg is jax_cls else CPU))
    m.update(*xs)
    return m.compute()


ERRORS = {
    "ce_norm": lambda fn, cls, b, m, l: fn.binary_calibration_error(*b, norm="l3"),
    "ce_n_bins": lambda fn, cls, b, m, l: fn.binary_calibration_error(*b, n_bins=0),
    "ce_int_preds": lambda fn, cls, b, m, l: fn.binary_calibration_error(b[1], b[1]),
    "ce_num_classes": lambda fn, cls, b, m, l: fn.multiclass_calibration_error(*m, 1),
    "ce_shape": lambda fn, cls, b, m, l: fn.multiclass_calibration_error(*m, C + 1),
    "ce_ndim": lambda fn, cls, b, m, l: fn.multiclass_calibration_error(m[1], m[1], C),
    "ce_task": lambda fn, cls, b, m, l: fn.calibration_error(*b, task="multilabel"),
    "ce_module_norm": lambda fn, cls, b, m, l: _module(cls, "BinaryCalibrationError", b, norm="l0"),
    "ce_facade_task": lambda fn, cls, b, m, l: cls.CalibrationError(task="multilabel"),
    "hinge_squared": lambda fn, cls, b, m, l: fn.binary_hinge_loss(*b, squared=1, validate_args=True),
    "hinge_mode": lambda fn, cls, b, m, l: fn.multiclass_hinge_loss(*m, C, multiclass_mode="ovr", validate_args=True),
    "hinge_int_preds": lambda fn, cls, b, m, l: fn.binary_hinge_loss(b[1], b[1], validate_args=True),
    "hinge_task": lambda fn, cls, b, m, l: fn.hinge_loss(*b, task="ranking"),
    "hinge_module_mode": lambda fn, cls, b, m, l: _module(cls, "MulticlassHingeLoss", m, C, multiclass_mode="x"),
    "rank_num_labels": lambda fn, cls, b, m, l: fn.multilabel_ranking_loss(*l, 1),
    "rank_shape": lambda fn, cls, b, m, l: fn.multilabel_coverage_error(*l, C + 1),
    "rank_int_preds": lambda fn, cls, b, m, l: fn.multilabel_ranking_average_precision(l[1], l[1], C),
    "rank_ignore": lambda fn, cls, b, m, l: _module(cls, "MultilabelRankingLoss", l, C, ignore_index=0.5),
}


@pytest.mark.parametrize("what", sorted(ERRORS))
def test_bad_arguments_raise_the_jax_errors(what):
    rng = np.random.default_rng(3)
    (jb, tb), (jm, tm), (jl, tl) = (both(binary_batch(rng, "float32", "int64", None)),
                                    both(multiclass_batch(rng, "float32", "int64", None)),
                                    both(multilabel_batch(rng, "float32", "int64", None)))
    assert _error(lambda: ERRORS[what](torch_fn, torch_cls, tb, tm, tl)) == \
        _error(lambda: ERRORS[what](jax_fn, jax_cls, jb, jm, jl))


def _ckpt_metric(pkg, name):
    """A fresh metric of the cross-read set, and the batches it sees."""
    extra = {} if pkg in (jax_top, jax_cls) else CPU
    rng = np.random.default_rng(seed_of("ckpt", name))
    if name == "CramersV":
        return pkg.CramersV(C, **extra), [tuple(rng.integers(0, C, (2, N)).astype(np.int64)) for _ in range(2)]
    if name == "MulticlassExactMatch":
        return (getattr(pkg, name)(C, multidim_average="samplewise", **extra),
                [(rng.integers(0, C, (8, X)), rng.integers(0, C, (8, X))) for _ in range(2)])
    return getattr(pkg, name)(n_bins=15, **extra), [binary_batch(rng, "float32", "int64", None) for _ in range(2)]


@pytest.mark.parametrize("saved_by", ["port", "jax"])
@pytest.mark.parametrize("name", ["CramersV", "MulticlassExactMatch", "BinaryCalibrationError"])
def test_a_saved_metric_restores_into_the_other_package(tmp_path, name, saved_by):
    """``save`` in one package after two updates, ``restore`` into a fresh
    metric of the other: every state (the int32 table, the samplewise list of
    int32 flags, the float32 bins) equal to the saver's, and the same value."""
    jpkg = jax_top if name == "CramersV" else jax_cls
    tpkg = torch_top if name == "CramersV" else torch_cls
    jm, batches = _ckpt_metric(jpkg, name)
    tm, _ = _ckpt_metric(tpkg, name)
    for b in batches:
        jb, tb = both(b)
        jm.update(*jb)
        tm.update(*tb)
    path = str(tmp_path / f"{name}.mtckpt")
    saver, reader = (tm, _ckpt_metric(jpkg, name)[0]) if saved_by == "port" else (jm, _ckpt_metric(tpkg, name)[0])
    saver.save(path)
    reader.restore(path)
    port_side = reader if saved_by == "jax" else tm
    jax_side = reader if saved_by == "port" else jm
    for key in jm._defaults:
        got, want = getattr(port_side, key), getattr(jax_side, key)
        if isinstance(want, list):
            assert len(got) == len(want) and all(g.dtype == torch.int32 for g in got)
            np.testing.assert_array_equal(torch.cat(got).numpy(), np.concatenate([np.asarray(w) for w in want]))
        else:
            assert str(got.dtype).replace("torch.", "") == str(np.asarray(want).dtype)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(port_side.compute().numpy(), np.asarray(jax_side.compute()), rtol=1e-5, atol=1e-6)
