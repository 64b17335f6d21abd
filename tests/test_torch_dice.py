"""The port's Dice score (functional and module, the legacy ``average`` /
``mdmc_average`` API) and the legacy input formatter it runs on, against the
JAX package's, on the CPU.

The same seeded numpy batches go through both packages in every input case the
formatter tells apart (``DataType``): binary scores, multilabel scores and
labels, multiclass scores and labels, multi-dim multiclass scores and labels;
float32, float64 and float16 scores, probabilities and logits; int32 and int64
labels; every ``average`` and ``mdmc_average``, ``zero_division`` 0 and 1,
``top_k`` 1 and 2, ``ignore_index`` None and an in-range class (its -1
sentinels). The formatter's int32 one-hot outputs and its case, and Dice's
int32 count states (tensors and samplewise list entries), are bit-identical;
values within rtol 1e-6 (float32 divisions of int32 counts). Where the JAX
package raises (an ``ignore_index`` out of range, a missing ``num_classes``,
a non-binary target of float preds), the port raises the same type and text.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jax_top
import metrics_tpu.functional.classification as jax_fn
import metrics_tpu.utils.checks as jax_checks
import metrics_tpu_torch as torch_top
import metrics_tpu_torch.functional.classification as torch_fn
import metrics_tpu_torch.utils.checks as torch_checks
from metrics_tpu_torch.utils.enums import DataType
from tests.test_torch_binary import CPU, close

C = 4
N = 24
X = 3


def seed_of(*parts):
    return sum(map(ord, repr(parts)))


def both(batch):
    return tuple(jnp.asarray(b) for b in batch), tuple(torch.from_numpy(np.ascontiguousarray(b)) for b in batch)


def batch(rng, case, score="float32", label="int64", logits=False):
    """(preds, target) of one legacy input case."""
    def scores(shape):
        x = rng.normal(0.0, 2.0, shape) if logits else rng.random(shape)
        return x.astype(score)

    def labels(shape, classes):
        return rng.integers(0, classes, shape).astype(label)

    if case == "binary":
        return scores((N,)), labels((N,), 2)
    if case == "multilabel":
        return scores((N, C)), labels((N, C), 2)
    if case == "multilabel_labels":
        return labels((N, C), 2), labels((N, C), 2)
    if case == "multiclass":
        return np.moveaxis(scores((N, C)), 0, 0), labels((N,), C)
    if case == "multiclass_labels":
        return labels((N,), C), labels((N,), C)
    if case == "mdmc":
        return scores((N // 4, C, X)), labels((N // 4, X), C)
    if case == "mdmc_labels":
        return labels((N // 4, X), C), labels((N // 4, X), C)
    raise ValueError(case)


CASE_TYPES = {"binary": DataType.BINARY, "multilabel": DataType.MULTILABEL,
              "multilabel_labels": DataType.MULTIDIM_MULTICLASS, "multiclass": DataType.MULTICLASS,
              "multiclass_labels": DataType.MULTICLASS, "mdmc": DataType.MULTIDIM_MULTICLASS,
              "mdmc_labels": DataType.MULTIDIM_MULTICLASS}


def outcome(fn):
    """The value, or the error's type and text."""
    try:
        return "ok", fn()
    except Exception as err:  # noqa: BLE001  (the error itself is what is compared)
        return type(err).__name__, str(err)


def same_outcome(tfn, jfn, compare=True):
    """Both packages return (values compared unless ``compare`` is false) or
    both raise the same error; True when they returned."""
    got, want = outcome(tfn), outcome(jfn)
    assert got[0] == want[0], (got, want)
    if got[0] != "ok":
        assert got[1] == want[1]
        return False
    if compare:
        close(got[1], want[1])
    return True


FORMAT_CASES = [(case, score, label, logits) for case in CASE_TYPES
                for score, label, logits in (("float32", "int64", False), ("float64", "int32", True),
                                             ("float16", "int64", False))]


@pytest.mark.parametrize("case,score,label,logits", FORMAT_CASES, ids=["-".join(map(str, c)) for c in FORMAT_CASES])
def test_the_legacy_formatter_matches_jax(case, score, label, logits):
    rng = np.random.default_rng(seed_of("fmt", case, score, label, logits))
    jb, tb = both(batch(rng, case, score, label, logits))
    for kw in ({}, {"top_k": 2}, {"num_classes": C}, {"threshold": 0.3}):
        ok = same_outcome(lambda: torch_checks._input_format_classification(*tb, **kw)[:2],
                          lambda: jax_checks._input_format_classification(*jb, **kw)[:2])
        if ok:
            got_case = torch_checks._input_format_classification(*tb, **kw)[2]
            want_case = jax_checks._input_format_classification(*jb, **kw)[2]
            assert got_case.value == want_case.value and isinstance(got_case, DataType)
            if not kw:
                assert got_case == CASE_TYPES[case]


def test_the_formatter_checks_raise_the_jax_errors():
    """Float targets, negative targets, negative label preds, a threshold
    outside (0, 1), a non-binary target of float preds, mismatched shapes,
    ``top_k`` on binary input: the JAX package's types and texts."""
    rng = np.random.default_rng(5)
    p, t = batch(rng, "multiclass_labels")
    s, _ = batch(rng, "binary")
    cases = [
        (s, t.astype(np.float32), {}), (p, t - 1, {}), (p - 1, t, {}), (p, t, {"threshold": 1.5}),
        (s, t, {}), (p[:-1], t, {}), (s, t % 2, {"top_k": 2}), (s[:, None, None], t, {}),
        (p.astype(np.float32)[:, None], t, {"num_classes": C + 2}), (p, t - 1, {"ignore_index": -1}),
    ]
    for preds, target, kw in cases:
        jb, tb = both((preds, target))
        same_outcome(lambda: torch_checks._input_format_classification(*tb, **kw)[:2],
                     lambda: jax_checks._input_format_classification(*jb, **kw)[:2])
    p2, t2 = both((p, t))[1]
    assert torch_checks._input_squeeze(p2[:1, None], t2[:1, None])[0].shape == (1, 1)
    assert torch_checks._input_squeeze(p2[:, None], t2[:, None])[0].shape == (N,)


AVERAGES = ("micro", "macro", "weighted", "samples", "none", None)
DICE_CASES = [(case, average, mdmc) for case in CASE_TYPES for average in AVERAGES
              for mdmc in ("global", "samplewise")]


@pytest.mark.parametrize("case,average,mdmc", DICE_CASES, ids=["-".join(map(str, c)) for c in DICE_CASES])
def test_dice_matches_jax(case, average, mdmc):
    """Functional and module over three batches: counts after every update,
    the value, for ``zero_division`` 0 and 1, ``ignore_index`` None and 1,
    ``top_k`` 1 (and 2 on scores)."""
    rng = np.random.default_rng(seed_of("dice", case, average, mdmc))
    score, label = ("float32", "int64") if len(case) % 2 else ("float64", "int32")
    batches = [batch(rng, case, score, label, logits=case == "multilabel") for _ in range(3)]
    variants = [{"num_classes": C}, {"num_classes": C, "zero_division": 1.0, "ignore_index": 1}]
    if case in ("multiclass", "mdmc"):
        variants.append({"num_classes": C, "top_k": 2})
    if case == "binary":
        variants = [{"num_classes": 1}, {"num_classes": 1, "threshold": 0.3}]
    for extra in variants:
        kw = {"average": average, "mdmc_average": mdmc, **extra}
        if not same_outcome(lambda: torch_top.Dice(**kw, **CPU), lambda: jax_top.Dice(**kw), compare=False):
            continue
        jm, tm = jax_top.Dice(**kw), torch_top.Dice(**kw, **CPU)
        for b in batches:
            jb, tb = both(b)
            if not same_outcome(lambda: torch_fn.dice(*tb, **kw), lambda: jax_fn.dice(*jb, **kw)):
                break
            jm.update(*jb)
            tm.update(*tb)
            for key in ("tp", "fp", "tn", "fn"):
                got, want = getattr(tm, key), getattr(jm, key)
                close(got, want)
                assert all(g.dtype == torch.int32 for g in (got if isinstance(got, list) else [got]))
        else:
            same_outcome(tm.compute, jm.compute)


def test_dice_of_the_docstring_cases():
    jb, tb = both((np.array([0, 2, 1, 2]), np.array([0, 1, 1, 2])))
    close(torch_fn.dice(*tb), jax_fn.dice(*jb))
    for average in ("macro", "none"):
        close(torch_fn.dice(*tb, average=average, num_classes=3), jax_fn.dice(*jb, average=average, num_classes=3))


def test_an_absent_class_is_left_out_and_the_ignored_class_is_nan():
    """A class in neither preds nor target: out of the macro mean, NaN under
    ``average="none"``; the ignored class: NaN under "none" too."""
    preds, target = np.array([0, 1, 1, 0, 3]), np.array([0, 1, 0, 0, 3])
    jb, tb = both((preds, target))
    for kw in ({"average": "macro"}, {"average": "none"}, {"average": "none", "ignore_index": 3},
               {"average": "weighted", "ignore_index": 0}, {"average": "micro", "ignore_index": 1}):
        got = torch_fn.dice(*tb, num_classes=C, **kw)
        close(got, jax_fn.dice(*jb, num_classes=C, **kw))
    assert torch.isnan(torch_fn.dice(*tb, num_classes=C, average="none")[2])


ERRORS = {
    "average": lambda pkg, fn, xs: fn.dice(*xs, average="mean"),
    "mdmc": lambda pkg, fn, xs: fn.dice(*xs, mdmc_average="all"),
    "num_classes_missing": lambda pkg, fn, xs: fn.dice(*xs, average="macro"),
    "ignore_out_of_range": lambda pkg, fn, xs: fn.dice(*xs, num_classes=C, ignore_index=C),
    "ignore_minus_one": lambda pkg, fn, xs: fn.dice(*xs, ignore_index=-1),
    "module_average": lambda pkg, fn, xs: pkg.Dice(average="mean", **({} if pkg is jax_top else CPU)),
    "module_ignore": lambda pkg, fn, xs: pkg.Dice(num_classes=C, ignore_index=-2, **({} if pkg is jax_top else CPU)),
}


@pytest.mark.parametrize("what", sorted(ERRORS))
def test_bad_arguments_raise_the_jax_errors(what):
    rng = np.random.default_rng(3)
    jb, tb = both(batch(rng, "multiclass_labels"))

    def error(fn):
        with pytest.raises(Exception) as info:
            fn()
        return type(info.value).__name__, str(info.value)

    assert error(lambda: ERRORS[what](torch_top, torch_fn, tb)) == error(lambda: ERRORS[what](jax_top, jax_fn, jb))
