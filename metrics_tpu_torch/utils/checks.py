"""Input validation helpers (port of ``metrics_tpu/utils/checks.py``, the part
that the ported classification validation calls, the legacy input formatter
that Dice uses, the retrieval input checks and
``check_forward_full_state_property``).

The JAX package skips value-dependent checks on traced arrays: inside
``jax.jit``, and so inside the serving engine's micro-batch kernel and
``Metric.jitted_update_state``. The port skips them in each torch analogue of
a trace: ``torch.compile``, CUDA-graph capture (a host read inside a capture
is an error), and every run of the code that a trace stands for, marked with
:func:`traced`: the engine's micro-batch scan (on the CPU a loop, on the card
the warm-up and the capture of its graph) and the graphed updater (its CPU
path, its warm-up and its capture). So a request is judged the same before a
graph exists and after, and the same on the CPU and on the card. The eager
paths (``update``, ``update_state``, the engine's eager retry and its demoted
path) keep their checks, as the JAX package's eager path keeps its own.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Iterator, Optional, Sequence, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.data import select_topk, to_onehot
from metrics_tpu_torch.utils.enums import DataType

_TRACE = threading.local()


@contextmanager
def traced() -> Iterator[None]:
    """Run the body as the JAX package runs a traced function: value-dependent
    checks are skipped on this thread until the body ends."""
    outer = getattr(_TRACE, "on", False)
    _TRACE.on = True
    try:
        yield
    finally:
        _TRACE.on = outer


def _value_check_possible(*tensors: Tensor) -> bool:
    """True unless a :func:`traced` body runs on this thread, ``torch.compile``
    is tracing, or the current CUDA stream is being captured into a graph
    (value-dependent checks may run)."""
    if getattr(_TRACE, "on", False) or torch.compiler.is_compiling():
        return False
    on_card = any(isinstance(t, Tensor) and t.is_cuda for t in tensors)
    return not (on_card and torch.cuda.is_current_stream_capturing())


def _check_same_shape(preds: Tensor, target: Tensor) -> None:
    """Raise if the shapes differ."""
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, but got {preds.shape} and {target.shape}."
        )


def _as_x32(x: Tensor) -> Tensor:
    """``x`` as the JAX package sees it with x64 off: float64 as float32, and
    integers other than int32 by their low 32 bits (bool stays bool)."""
    x = torch.as_tensor(x)
    if x.dtype == torch.float64:
        return x.to(torch.float32)
    if not x.is_floating_point() and x.dtype not in (torch.int32, torch.bool):
        return x.to(torch.int32)
    return x


def _basic_input_validation(preds: Tensor, target: Tensor, threshold: float, ignore_index: Optional[int]) -> None:
    """Checks common to every legacy input: integer, non-negative targets (but
    ``ignore_index``), non-negative integer preds, a threshold in (0, 1)."""
    if _value_check_possible(target) and target.is_floating_point():
        raise ValueError("The `target` has to be an integer tensor.")

    if _value_check_possible(target):
        unique_values = torch.unique(target)
        negative = (unique_values != 0) & (unique_values != 1) & (unique_values < 0)
        if ignore_index is not None:
            negative = negative & (unique_values != ignore_index)
        if bool(torch.any(negative)):
            raise ValueError("The `target` has to be a non-negative tensor.")

    if _value_check_possible(preds) and not preds.is_floating_point() and bool(torch.any(preds < 0)):
        raise ValueError("If `preds` are integers, they have to be non-negative.")

    if not 0 < threshold < 1:
        raise ValueError(f"The `threshold` should be a float in the (0,1) interval, got {threshold}")


def _check_shape_and_type_consistency(preds: Tensor, target: Tensor) -> Tuple[DataType, int]:
    """The input case (binary, multiclass, multilabel or multi-dim multiclass)
    and the number of classes the shapes imply."""
    preds_float = preds.is_floating_point()

    if preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError("The `preds` and `target` should have the same shape, got different shapes.")
        if preds_float and _value_check_possible(target) and target.numel() and int(target.max()) > 1:
            raise ValueError("If `preds` and `target` are of shape (N, ...) and `preds` are floats, `target` should be binary.")
        if preds.ndim == 1:
            case = DataType.BINARY if preds_float else DataType.MULTICLASS
        else:
            case = DataType.MULTILABEL if preds_float else DataType.MULTIDIM_MULTICLASS
        implied_classes = preds.shape[1] if preds.ndim > 1 else 1
    elif preds.ndim == target.ndim + 1:
        if not preds_float:
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError("If `preds` have one dimension more than `target`, the shape must be (N, C, ...).")
        implied_classes = preds.shape[1]
        case = DataType.MULTICLASS if preds.ndim == 2 else DataType.MULTIDIM_MULTICLASS
    else:
        raise ValueError("Either `preds` and `target` both should have the (same) shape (N, ...), or `target` (N, ...) and `preds` (N, C, ...).")
    return case, implied_classes


def _check_classification_inputs(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    num_classes: Optional[int],
    multiclass: Optional[bool],
    top_k: Optional[int],
    ignore_index: Optional[int] = None,
) -> DataType:
    """Validate a legacy input pair and return its case."""
    _basic_input_validation(preds, target, threshold, ignore_index)
    case, implied_classes = _check_shape_and_type_consistency(preds, target)
    if num_classes is not None and case != DataType.BINARY and num_classes != implied_classes and preds.ndim != target.ndim:
        raise ValueError(f"num_classes={num_classes} does not match implied classes {implied_classes}")
    if top_k is not None and case not in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) and not (
        case == DataType.MULTILABEL and top_k == 1
    ):
        if top_k != 1:
            raise ValueError("You can only use `top_k` with multiclass inputs.")
    return case


def _input_squeeze(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Remove excess dimensions: a batch of one becomes ``(1, -1)``, any other
    batch loses its size-1 dimensions."""
    if preds.shape[0] == 1:
        return preds.reshape(1, -1), target.reshape(1, -1)
    return preds.squeeze(), target.squeeze()


def _max_label(x: Tensor) -> int:
    return int(x.max()) if x.numel() else 0


def _input_format_classification(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, DataType]:
    """Legacy formatter: any valid input pair to int32 0/1 ``(N, C)`` tensors
    (multi-dim input flattened to ``(N * X, C)``), and the detected case.

    The case is decided from shapes and, where they leave it open, values:
    float preds of a target's shape need a binary target, float preds outside
    [0, 1] go through a sigmoid, and label inputs without ``num_classes`` take
    their largest label + 1 (host reads, as in the JAX package). An
    out-of-range label, such as an ``ignore_index`` of -1, one-hots to a zero row.
    """
    preds = _as_x32(preds)
    target = _as_x32(target)
    if preds.ndim == 0:
        preds = preds.reshape(1)
    if target.ndim == 0:
        target = target.reshape(1)
    case = _check_classification_inputs(
        preds, target, threshold=threshold, num_classes=num_classes, multiclass=multiclass, top_k=top_k,
        ignore_index=ignore_index,
    )
    preds_float = preds.is_floating_point()
    top_k = top_k if top_k else 1

    if case in (DataType.BINARY, DataType.MULTILABEL) and not top_k > 1:
        if preds_float:
            if _value_check_possible(preds) and bool(torch.any((preds < 0) | (preds > 1))):
                preds = torch.sigmoid(preds)
            preds = (preds >= threshold).to(torch.int32)
        else:
            preds = preds.to(torch.int32)
        preds = preds.reshape(preds.shape[0], -1)
        target = target.reshape(target.shape[0], -1).to(torch.int32)
        if multiclass and case == DataType.BINARY:
            target = to_onehot(target.reshape(-1), 2).reshape(target.shape[0] * target.shape[1], 2)
    elif case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) or top_k > 1:
        nc = num_classes
        if nc is None:
            if preds.ndim == target.ndim + 1:
                nc = preds.shape[1]
            else:
                if not _value_check_possible(preds, target):
                    raise ValueError("num_classes must be given explicitly inside jit")
                nc = max(_max_label(preds), _max_label(target), 0) + 1
        if preds.ndim == target.ndim + 1:  # probabilities or logits
            preds = select_topk(preds, top_k, dim=1)
        else:
            preds = to_onehot(preds.to(torch.int32), nc)
        target = to_onehot(target.to(torch.int32), nc)
        if preds.ndim > 2 and case != DataType.MULTIDIM_MULTICLASS:
            preds = preds.reshape(preds.shape[0], -1)
        if preds.ndim > 2:  # (N, C, X) to (N * X, C)
            preds = torch.movedim(preds, 1, -1).reshape(-1, nc)
            target = torch.movedim(target, 1, -1).reshape(-1, nc)
        preds = preds.reshape(-1, nc).to(torch.int32)
        target = target.reshape(-1, nc).to(torch.int32)
    else:
        raise ValueError(f"Unsupported input case {case}")
    return preds, target, case


def _check_retrieval_shape(indexes: Tensor, preds: Tensor, target: Tensor) -> None:
    if indexes.shape != preds.shape or target.shape != preds.shape:
        raise IndexError("`indexes`, `preds` and `target` must be of the same shape")


def _is_integer(x: Tensor) -> bool:
    return not x.is_floating_point() and not x.is_complex() and x.dtype != torch.bool


def _check_retrieval_inputs(
    indexes: Tensor,
    preds: Tensor,
    target: Tensor,
    allow_non_binary_target: bool = False,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Check retrieval inputs and flatten them: int32 query ids, float32 scores
    and the targets as the JAX package sees them with x64 off.

    Ids and targets of other integer types keep their low 32 bits (an int64
    id at or above 2^31 wraps, as ``jnp.asarray`` wraps it; ROADMAP C.3);
    ``ignore_index`` is compared after that truncation. Dropping the ignored
    documents and the binary check read values, so both are skipped under a
    trace analogue (:func:`traced`, a capture; ROADMAP C.4), as under ``jax.jit``.
    """
    indexes, preds, target = (torch.as_tensor(x) for x in (indexes, preds, target))
    if indexes.ndim == 0 or preds.ndim == 0 or target.ndim == 0:
        raise ValueError("`indexes`, `preds` and `target` must be non-empty and non-scalar tensors")
    _check_retrieval_shape(indexes, preds, target)
    if not _is_integer(indexes):
        raise ValueError("`indexes` must be a tensor of long integers")
    if not preds.is_floating_point():
        raise ValueError("`preds` must be a tensor of floats")
    if not (_is_integer(target) or target.dtype == torch.bool):
        raise ValueError("`target` must be a tensor of booleans or integers")
    indexes, target = _as_x32(indexes), _as_x32(target)
    if ignore_index is not None and _value_check_possible(target):
        valid = target != ignore_index
        indexes, preds, target = indexes[valid], preds[valid], target[valid]
    if (
        not allow_non_binary_target
        and _value_check_possible(target)
        and bool(torch.any((target > 1) | (target < 0)))
    ):
        raise ValueError("`target` must contain `binary` values")
    return indexes.reshape(-1), preds.reshape(-1).to(torch.float32), target.reshape(-1)


def _allclose_recursive(res1: Any, res2: Any, atol: float = 1e-8) -> bool:
    """``torch.allclose`` over nested lists, tuples and dicts of tensors."""
    if isinstance(res1, (list, tuple)):
        return all(_allclose_recursive(r1, r2, atol) for r1, r2 in zip(res1, res2))
    if isinstance(res1, dict):
        return all(_allclose_recursive(res1[k], res2[k], atol) for k in res1)
    return bool(torch.allclose(torch.as_tensor(res1), torch.as_tensor(res2), atol=atol))


def check_forward_full_state_property(
    metric_class: Any,
    init_args: Optional[dict] = None,
    input_args: Optional[dict] = None,
    num_update_to_compare: Sequence[int] = (10, 100, 1000),
    reps: int = 5,
) -> None:
    """Whether ``metric_class`` may set ``full_state_update=False``: its
    ``forward`` is run both ways on ``input_args`` and the outputs compared,
    then both ways are timed over ``num_update_to_compare`` forwards, ``reps``
    times each; the verdict is printed. ``init_args`` should name the device
    (``{"device": "cpu"}``)."""
    import time

    init_args = init_args or {}
    input_args = input_args or {}

    class FullState(metric_class):
        full_state_update = True

    class PartState(metric_class):
        full_state_update = False

    fullstate = FullState(**init_args)
    partstate = PartState(**init_args)

    equal = True
    for _ in range(max(num_update_to_compare)):
        out1 = fullstate(**input_args)
        out2 = partstate(**input_args)
        equal = equal and _allclose_recursive(out1, out2)
    res1 = fullstate.compute()
    res2 = partstate.compute()
    equal = equal and _allclose_recursive(res1, res2)
    mean_full, mean_part = [], []
    for metric in (FullState, PartState):
        out = mean_full if metric is FullState else mean_part
        for num in num_update_to_compare:
            m = metric(**init_args)
            start = time.perf_counter()
            for _ in range(reps):
                for _ in range(num):
                    m(**input_args)
                m.reset()
            out.append((time.perf_counter() - start) / reps)
    faster = sum(mean_part) < sum(mean_full)
    print(f"Output equal: {equal}; partial-state faster: {faster}")
    if equal and faster:
        print(f"Recommended: set `full_state_update=False` on {metric_class.__name__}")
