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

The data-parallel half of ``__graft_entry__.py::dryrun_multichip``:
:func:`make_dp_step` is the step each rank runs on its own batch (the loss
and the gradients averaged over ``dp`` with
:func:`~metrics_tpu_torch.parallel.sync.reduce_in_trace`, then each metric's
``update_state`` → ``sync_state(s, "dp")`` → ``compute_from``),
:func:`make_token_metric_step` the sequence-parallel token metric synced over
``("dp", "sp")``, and :func:`dryrun_data_parallel` runs one of each over a
``DeviceMesh`` with dimensions ``("dp", "sp")``, every rank cutting its shard
of one global batch made from the seed. Its tensor-, pipeline- and
expert-parallel dry runs are not ported.
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
from metrics_tpu_torch.parallel.sync import reduce_in_trace, use_mesh
from metrics_tpu_torch.utils.device import DeviceLike, resolve_device

# The full width of bench.py's accelerator configuration.
FULL_CONFIG = {"batch": 1024, "hidden": 4096, "classes": 1000, "layers": 8}
LEARNING_RATE = 0.01
# dryrun_multichip's tiny shapes: rows of the batch and tokens of a sequence per
# shard, the width and the classes of __graft_entry__.py
DRYRUN_CONFIG = {"batch": 4, "seq": 8, "hidden": 32, "classes": 8, "layers": 1}

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


# ---------------------------------------------------------------------- data parallel


def dp_sgd_step(params: Params, x: Tensor, y: Tensor, axis_name: Any = "dp") -> Tuple[Params, Tensor, Tensor]:
    """:func:`sgd_step` on this rank's batch with the loss and every gradient
    averaged over ``axis_name`` (``lax.pmean``: an all-reduce, then ``/ n``),
    so every rank applies the same update: ``(new_params, mean_loss, logits)``."""
    leaves = [p.detach().requires_grad_(True) for p in (*params["ws"], params["head"])]
    n = len(params["ws"])
    loss, logits = forward({"ws": leaves[:n], "head": leaves[n]}, x, y)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        new = [p - LEARNING_RATE * reduce_in_trace(g, "mean", axis_name) for p, g in zip(leaves, grads)]
    return {"ws": new[:n], "head": new[n]}, reduce_in_trace(loss.detach(), "mean", axis_name), logits.detach()


def make_dp_step(
    metrics: Dict[str, Metric], axis_name: Any = "dp"
) -> Callable[..., Tuple[Tensor, Params, Dict[str, Any], Dict[str, Any]]]:
    """The data-parallel step ``(params, states, x, y) -> (mean_loss,
    new_params, new_states, values)`` of ``dryrun_multichip``: each metric's
    ``update_state`` on this rank's predictions, ``sync_state(s, axis_name)``
    and ``compute_from`` of the synced state. ``new_states`` are the local
    states (fed to the next step; feeding the synced ones would count the
    other ranks' batches again at the next sync); ``values`` are global."""

    def step(params: Params, states: Dict[str, Any], x: Tensor, y: Tensor):
        params, loss, logits = dp_sgd_step(params, x, y, axis_name)
        preds = torch.argmax(logits, dim=-1)
        new_states, values = {}, {}
        for name, m in metrics.items():
            new_states[name] = m.update_state(states[name], preds, y)
            values[name] = m.compute_from(m.sync_state(new_states[name], axis_name))
        return loss, params, new_states, values

    step.metrics = metrics  # type: ignore[attr-defined]
    return step


def make_token_metric_step(metric: Metric, axis_name: Any = ("dp", "sp")) -> Callable[..., Tuple[Dict[str, Any], Any]]:
    """The sequence-parallel token metric's step ``(state, preds, target) ->
    (synced_state, value)``: the stat-score sums reduce over both axes."""

    def step(state: Dict[str, Any], preds: Tensor, target: Tensor):
        state = metric.sync_state(metric.update_state(state, preds, target), axis_name)
        return state, metric.compute_from(state)

    return step


def dryrun_data_parallel(mesh: Any, device: DeviceLike = None, seed: int = 0, **config: int) -> Dict[str, Any]:
    """One data-parallel training step over ``mesh``'s ``dp`` dimension and one
    token-metric pass over ``("dp", "sp")``, at ``DRYRUN_CONFIG``'s sizes per
    shard (overridable by keyword). Every rank makes the same global batch from
    ``seed`` and cuts its shard: rows by its ``dp`` coordinate (replicated over
    ``sp``, as the JAX dry run replicates the batch over ``tp``), token blocks
    by both. Returns this rank's ``loss``, ``values``, the token metric's
    ``token_value`` and its ``token_expected`` from the whole global batch."""
    from metrics_tpu_torch.classification import MulticlassAccuracy

    cfg = {**DRYRUN_CONFIG, **config}
    dev = resolve_device(device)
    dp, sp = (mesh.size(mesh.mesh_dim_names.index(n)) for n in ("dp", "sp"))
    i, j = (mesh.get_local_rank(n) for n in ("dp", "sp"))
    batch, seq = cfg["batch"] * dp, cfg["seq"] * sp
    params, x, y = make_inputs(seed, batch, cfg["hidden"], cfg["classes"], cfg["layers"], dev)
    rows = slice(i * cfg["batch"], (i + 1) * cfg["batch"])
    metrics = make_metrics(cfg["classes"], dev)
    states = {name: m.init_state() for name, m in metrics.items()}
    rng = np.random.default_rng(seed + 1)
    preds_tok = torch.from_numpy(rng.integers(0, cfg["classes"], (batch, seq))).to(dev)
    target_tok = torch.from_numpy(rng.integers(0, cfg["classes"], (batch, seq))).to(dev)
    block = (rows, slice(j * cfg["seq"], (j + 1) * cfg["seq"]))
    acc = MulticlassAccuracy(cfg["classes"], average="micro", multidim_average="global", validate_args=False,
                             device=dev)
    with use_mesh(mesh):
        loss, _, _, values = make_dp_step(metrics)(params, states, x[rows], y[rows])
        _, token_value = make_token_metric_step(acc)(acc.init_state(), preds_tok[block], target_tok[block])
    if not torch.isfinite(loss):
        raise RuntimeError("the data-parallel training step produced a non-finite loss")
    return {"loss": loss, "values": values, "token_value": token_value,
            "token_expected": (preds_tok == target_tok).to(torch.float32).mean()}
