"""The flagship workload in PyTorch: an MLP training step with three metrics
fused into it through the functional API.

It is the twin of the metric step of ``bench.py::run_benchmark`` and of
``__graft_entry__.py::entry``: forward through ``layers`` tanh layers and a
linear head, cross-entropy loss, autograd backward, the SGD update
``p - 0.01 * g``, ``argmax`` predictions, and one ``update_state`` each for
``MulticlassAccuracy(average="micro")``, ``MulticlassF1Score(average="macro")``
and ``MulticlassConfusionMatrix``. Each of the three updates runs one pair
count, so on the GPU a step launches the CUDA pair-count kernel three times.
With the three metrics in a ``MetricCollection`` whose compute groups are
formed (one eager ``update``), accuracy and F1 share one state, and a step
launches the kernel twice: the confusion matrix's ``(C, C)`` state joins no
group.

Weights keep the JAX layout ``(fan_in, fan_out)`` and are applied as
``h @ w``. The matrix products stay ``torch.matmul`` with autograd, as the
JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from metrics_tpu_torch.classification import MulticlassAccuracy, MulticlassConfusionMatrix, MulticlassF1Score
from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.device import DeviceLike, resolve_device

# The full width of bench.py's accelerator configuration.
FULL_CONFIG = {"batch": 1024, "hidden": 4096, "classes": 1000, "layers": 8}
LEARNING_RATE = 0.01

Params = Dict[str, Union[Tensor, List[Tensor]]]


def make_metrics(num_classes: int, device: DeviceLike = None) -> Dict[str, Metric]:
    """The three flagship metrics, with argument validation off as in ``bench.py``."""
    kw: Dict[str, Any] = {"validate_args": False, "device": device}
    return {
        "accuracy": MulticlassAccuracy(num_classes, average="micro", **kw),
        "f1": MulticlassF1Score(num_classes, average="macro", **kw),
        "confmat": MulticlassConfusionMatrix(num_classes, **kw),
    }


def forward(params: Params, x: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
    """``(loss, logits)``: tanh MLP, linear head, mean cross-entropy."""
    h = x
    for w in params["ws"]:
        h = torch.tanh(h @ w)
    logits = h @ params["head"]
    logp = F.log_softmax(logits, dim=-1)
    loss = -torch.mean(torch.gather(logp, 1, y[:, None]))
    return loss, logits


def sgd_step(params: Params, x: Tensor, y: Tensor) -> Tuple[Params, Tensor, Tensor]:
    """The bare train step: ``(new_params, loss, logits)``. ``params`` is left as it was."""
    leaves = [p.detach().requires_grad_(True) for p in (*params["ws"], params["head"])]
    n = len(params["ws"])
    loss, logits = forward({"ws": leaves[:n], "head": leaves[n]}, x, y)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        new = [p - LEARNING_RATE * g for p, g in zip(leaves, grads)]
    return {"ws": new[:n], "head": new[n]}, loss.detach(), logits.detach()


def make_step(
    metrics: Union[Dict[str, Metric], MetricCollection],
) -> Callable[..., Tuple[Tensor, Params, Dict[str, Any]]]:
    """The fused step ``(params, states, x, y) -> (loss, new_params, new_states)``;
    ``step.metrics`` holds ``metrics`` for ``compute_from``. ``metrics`` is a
    dict of metrics (``states`` keyed by its names) or a ``MetricCollection``
    (``states`` from its ``init_state``)."""

    def step(params: Params, states: Dict[str, Any], x: Tensor, y: Tensor) -> Tuple[Tensor, Params, Dict[str, Any]]:
        params, loss, logits = sgd_step(params, x, y)
        preds = torch.argmax(logits, dim=-1)
        if isinstance(metrics, MetricCollection):
            return loss, params, metrics.update_state(states, preds, y)
        new_states = {name: m.update_state(states[name], preds, y) for name, m in metrics.items()}
        return loss, params, new_states

    step.metrics = metrics  # type: ignore[attr-defined]
    return step


def make_inputs(
    seed: int, batch: int, hidden: int, classes: int, layers: int, device: DeviceLike = None
) -> Tuple[Params, Tensor, Tensor]:
    """Random float32 weights (normal * 0.02, as ``bench.py``), inputs and labels from ``seed`` with numpy."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def normal(*shape: int, scale: float = 1.0) -> Tensor:
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    params: Params = {
        "ws": [normal(hidden, hidden, scale=0.02) for _ in range(layers)],
        "head": normal(hidden, classes, scale=0.02),
    }
    x = normal(batch, hidden)
    y = torch.from_numpy(rng.integers(0, classes, batch)).to(dev)
    return params, x, y


def entry(device: DeviceLike = None, seed: int = 0, **config: int) -> Tuple[Callable, Tuple[Any, ...]]:
    """``(step, (params, states, x, y))`` at the full width of ``FULL_CONFIG``
    (overridable by keyword), on the GPU unless ``device`` says otherwise."""
    cfg = {**FULL_CONFIG, **config}
    dev = resolve_device(device)
    metrics = make_metrics(cfg["classes"], dev)
    params, x, y = make_inputs(seed, cfg["batch"], cfg["hidden"], cfg["classes"], cfg["layers"], dev)
    states = {name: m.init_state() for name, m in metrics.items()}
    return make_step(metrics), (params, states, x, y)
