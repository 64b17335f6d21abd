"""BootStrapper: bootstrapped confidence estimates for any metric (port of
``metrics_tpu/wrappers/bootstrapping.py``).

Each update resamples the batch once per bootstrap copy, from a numpy PCG64
generator: Poisson(1) multiplicities by a 36-entry inverse CDF, or, with
``sampling_strategy="multinomial"``, one ``(num_bootstraps, batch)`` index
matrix. The draws are the JAX package's draws for the same seed, so both
packages resample the same rows.

With ``"multinomial"`` the resample has a fixed shape, so one state stacked
along a leading bootstrap axis is updated by ONE ``torch.func.vmap`` of the
base metric's ``update_state`` (the JAX package's ``jax.vmap``), run under
:func:`~metrics_tpu_torch.utils.checks.traced` (value checks are skipped, as a
JAX trace skips them). The hand kernels run inside it through their batching
rules (:mod:`metrics_tpu_torch.kernels._batched`): a kernel launch per copy,
counted as any launch. An update that torch cannot vmap (``.item()``, a
boolean mask, ``.tolist()``: torch raises ``RuntimeError`` where JAX raises
``TypeError`` or ``IndexError``) turns the instance for good into one metric
per copy, and the loop re-runs the update there, so a genuine error is raised
and not hidden. A hand kernel's launch failure is never taken for such an
update: it is raised (:class:`~metrics_tpu_torch.kernels._build.KernelLaunchError`).
Poisson resampling, host-compute metrics and list states keep the per-copy
loop from the start.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch import Tensor
from torch.utils._pytree import tree_flatten

from metrics_tpu_torch.kernels._build import KernelLaunchError
from metrics_tpu_torch.metric import Metric, _as_state_tensor, _raise_on_unconsumed
from metrics_tpu_torch.utils.checks import traced
from metrics_tpu_torch.utils.data import apply_to_collection
from metrics_tpu_torch.utils.device import DeviceLike

# CDF of Poisson(lam=1) at k=0..35: P(X<=k) = e^-1 * sum_{i<=k} 1/i!
_POISSON1_CDF = np.cumsum(np.exp(-1.0) / np.cumprod(np.concatenate([[1.0], np.arange(1.0, 36.0)])))


def _chunk_spans(n: int, chunkable: bool):
    """Split ``[0, n)`` into a 4096-aligned head span and power-of-two tail
    spans, as the JAX package does (it bounds the shapes its jitted updates
    see). Each span is one update of a copy, so the spans set the copy's
    update count and the order of its float sums."""
    if not chunkable or n <= 0:
        return [(0, n)]
    spans = []
    head = (n >> 12) << 12
    if head:
        spans.append((0, head))
    off = head
    while off < n:
        chunk = 1 << ((n - off).bit_length() - 1)
        spans.append((off, off + chunk))
        off += chunk
    return spans


def _bootstrap_sampler(
    size: int,
    sampling_strategy: str = "poisson",
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Resampling indices of one copy, a host numpy array: Poisson(1)
    multiplicities by an inverse CDF of one uniform draw each, or ``size``
    uniform indices."""
    rng = rng or np.random.default_rng()
    if sampling_strategy == "poisson":
        p = np.searchsorted(_POISSON1_CDF, rng.random(size), side="left")
        return np.arange(size).repeat(p)
    if sampling_strategy == "multinomial":
        return rng.integers(0, size, size)
    raise ValueError("Unknown sampling strategy")


def _as_array(value: Any) -> Tensor:
    """``jnp.asarray`` of a metric's value: a tuple or list (heavy hitters'
    keys and counts) is stacked."""
    if isinstance(value, (tuple, list)):
        return torch.stack([_as_array(v) for v in value])
    return torch.as_tensor(value)


def _take(tree: Any, idx: Tensor) -> Any:
    """Every tensor of ``tree`` gathered at ``idx`` along dimension 0 (the
    index moved once to each device it meets)."""
    on: Dict[torch.device, Tensor] = {}

    def gather(x: Tensor) -> Tensor:
        if x.device not in on:
            on[x.device] = idx.to(x.device)
        return x.index_select(0, on[x.device])

    return apply_to_collection(tree, Tensor, gather)


class BootStrapper(Metric):
    """Bootstrap confidence intervals, with one vmapped update over resampled copies.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import BootStrapper, MeanSquaredError
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0, 4.5, 1.0, 3.0, 6.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0, 4.0, 1.5, 2.5, 6.5])
        >>> metric = BootStrapper(MeanSquaredError(device="cpu"), num_bootstraps=20, seed=123)
        >>> metric.update(preds, target)
        >>> sorted(metric.compute().keys())
        ['mean', 'std']
        >>> bool(abs(float(metric.compute()["mean"]) - 0.3) < 0.2)  # MSE is 0.3125 exactly
        True
    """

    full_state_update: Optional[bool] = True

    def __init__(
        self,
        base_metric: Metric,
        num_bootstraps: int = 10,
        mean: bool = True,
        std: bool = True,
        quantile: Optional[Union[float, Tensor]] = None,
        raw: bool = False,
        sampling_strategy: str = "poisson",
        seed: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of metrics_tpu.Metric but received {base_metric}"
            )
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self.num_bootstraps = num_bootstraps

        self.mean = mean
        self.std = std
        self.quantile = quantile
        self.raw = raw

        allowed_sampling = ("poisson", "multinomial")
        if sampling_strategy not in allowed_sampling:
            raise ValueError(
                f"Expected argument ``sampling_strategy`` to be one of {allowed_sampling} but received"
                f" {sampling_strategy}"
            )
        self.sampling_strategy = sampling_strategy
        self._rng = np.random.default_rng(seed)

        self.base_metric = base_metric
        has_list_state = any(isinstance(d, list) for d in base_metric._defaults.values())
        self._use_vmap = (
            sampling_strategy == "multinomial"
            and not getattr(base_metric, "_host_compute", False)
            and not has_list_state
        )
        if self._use_vmap:
            self.metrics = []  # no copies needed: the state carries the bootstrap axis
            self._stacked_state = self._init_stacked_state()
        else:
            self.metrics = [deepcopy(base_metric) for _ in range(num_bootstraps)]

    def _init_stacked_state(self) -> Dict[str, Any]:
        base = self.base_metric.init_state()
        return {k: v.expand((self.num_bootstraps,) + tuple(v.shape)).clone() for k, v in base.items()}

    def _vmap_update(self, *args: Any, **kwargs: Any) -> bool:
        """One vmapped update over the stacked state. False if torch cannot vmap it."""
        leaf = self._batch_leaf(args, kwargs)
        size = leaf.shape[0]
        # One (N, size) draw fills row-major, so row i equals the i-th sequential
        # draw of the per-copy loop: the same resampling stream.
        indices = torch.from_numpy(self._rng.integers(0, size, (self.num_bootstraps, size))).to(leaf.device)

        def one_copy(state: Dict[str, Any], idx: Tensor) -> Dict[str, Any]:
            return self.base_metric.update_state(state, *_take(args, idx), **_take(kwargs, idx))

        try:
            with traced():
                self._stacked_state = torch.func.vmap(one_copy)(self._stacked_state, indices)
        except KernelLaunchError:
            raise
        except RuntimeError:
            # torch's refusal to vmap a data-dependent update (the JAX package's
            # TypeError / IndexError under jax.vmap). A genuine fault of the base
            # metric's update is not hidden: the loop re-runs it eagerly and raises.
            return False
        return True

    @staticmethod
    def _batch_leaf(args: Any, kwargs: Any) -> Tensor:
        """The first tensor with a dimension: its length is the resample
        size (tensors are the only leaves the gather touches)."""
        for leaf in tree_flatten((args, kwargs))[0]:
            if isinstance(leaf, Tensor) and leaf.ndim > 0:
                return leaf
        raise ValueError("None of the input contained tensors, so could not determine the sampling size")

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Resample the batch once per bootstrap copy."""
        if self._use_vmap:
            if self._vmap_update(*args, **kwargs):
                return
            # for good: per-copy metrics from the stacked state so far, then the loop
            self._use_vmap = False
            self.metrics = [deepcopy(self.base_metric) for _ in range(self.num_bootstraps)]
            for i, m in enumerate(self.metrics):
                m._swap_in({k: v[i] for k, v in self._stacked_state.items()})
            del self._stacked_state

        size = self._batch_leaf(args, kwargs).shape[0]
        chunkable = self._chunkable(args, kwargs)
        for idx in range(self.num_bootstraps):
            sample_idx = _bootstrap_sampler(size, self.sampling_strategy, self._rng)
            if sample_idx.size == 0:
                continue
            for lo, hi in _chunk_spans(int(sample_idx.size), chunkable):
                chunk = torch.from_numpy(sample_idx[lo:hi])
                self.metrics[idx].update(*_take(args, chunk), **_take(kwargs, chunk))

    @staticmethod
    def _chunkable(args: Any, kwargs: Any) -> bool:
        """Chunking applies when every leaf is a tensor (gathered along
        dimension 0) or a scalar or flag passed through; host batch content
        such as strings must reach the base metric in one call."""
        leaves = tree_flatten((args, kwargs))[0]
        return any(isinstance(leaf, Tensor) for leaf in leaves) and all(
            isinstance(leaf, (Tensor, bool, int, float, complex, type(None))) for leaf in leaves
        )

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Tensor]:
        """Accumulate globally AND return the batch-only bootstrap statistics.

        ``Metric.forward`` caches only registered states, which would drop the
        stacked state and the copies' states across its reset, so the cache,
        reset and restore are done here over the wrapper's own state.
        """
        self.update(*args, **kwargs)

        if self._use_vmap:
            cache = self._stacked_state
            self._stacked_state = self._init_stacked_state()
        else:
            cache = [m._swap_in(m.init_state()) for m in self.metrics]  # reset, keep the snapshot

        try:
            self.update(*args, **kwargs)
            self._computed = None
            batch_value = self.compute()
        finally:
            if self._use_vmap:
                self._stacked_state = cache
            else:
                for m, snapshot in zip(self.metrics, cache):
                    m._swap_in(snapshot)
                    m._computed = None  # drop the batch value cached with the state
            self._computed = None
        return batch_value

    def compute(self) -> Dict[str, Tensor]:
        """``mean``, ``std`` (``correction=1``), ``quantile`` (linear) and
        ``raw`` over the copies' computes."""
        if self._use_vmap:
            computed_vals = torch.func.vmap(lambda s: _as_array(self.base_metric.compute_from(s)))(
                self._stacked_state
            )
        else:
            computed_vals = torch.stack([_as_array(m.compute()) for m in self.metrics], dim=0)
        # jnp.mean and jnp.std of integer values are float32
        values = computed_vals if computed_vals.is_floating_point() else computed_vals.to(torch.float32)
        output_dict = {}
        if self.mean:
            output_dict["mean"] = torch.mean(values, dim=0)
        if self.std:
            output_dict["std"] = torch.std(values, dim=0, correction=1)
        if self.quantile is not None:
            q = torch.as_tensor(self.quantile, dtype=values.dtype, device=values.device)
            output_dict["quantile"] = torch.quantile(values, q, dim=0)
        if self.raw:
            output_dict["raw"] = computed_vals
        return output_dict

    def reset(self) -> None:
        if self._use_vmap:
            self._stacked_state = self._init_stacked_state()
        for m in self.metrics:
            m.reset()
        super().reset()

    def to_device(self, device: DeviceLike) -> "BootStrapper":
        """Move the base metric, the copies and the stacked state to ``device``."""
        super().to_device(device)
        for m in (self.base_metric, *self.metrics):
            m.to_device(device)
        if self._use_vmap:
            self._stacked_state = {k: v.to(self.device) for k, v in self._stacked_state.items()}
        return self

    def set_dtype(self, dst_type: torch.dtype) -> "BootStrapper":
        """Convert the floating-point states of the base metric, the copies and
        the stacked state to ``dst_type``."""
        super().set_dtype(dst_type)
        for m in (self.base_metric, *self.metrics):
            m.set_dtype(dst_type)
        if self._use_vmap:
            self._stacked_state = {k: v.to(dst_type) if v.is_floating_point() else v
                                   for k, v in self._stacked_state.items()}
        return self

    # ------------------------------------------------------------------ persistence
    # The stacked path keeps its accumulation in ``_stacked_state`` (a plain
    # dict, not registered states), and both paths draw from ``self._rng``: a
    # checkpoint carries the stacked state and the generator's state, or a
    # resume restarts the bootstrap and diverges from an uninterrupted run.
    # The copies are child metrics, saved by the base class's recursion. The
    # keys are the JAX package's, and the flags, the strategy and the
    # generator's state stay numpy arrays, so snapshots cross-read both ways.

    @staticmethod
    def _encode_rng_state(rng: np.random.Generator) -> Optional[np.ndarray]:
        """The PCG64 state as a (6,) uint64 array (None for another generator)."""
        st = rng.bit_generator.state
        if st.get("bit_generator") != "PCG64":
            return None
        m64 = (1 << 64) - 1
        s, inc = st["state"]["state"], st["state"]["inc"]
        return np.array([s & m64, (s >> 64) & m64, inc & m64, (inc >> 64) & m64,
                         st["has_uint32"], st["uinteger"]], dtype=np.uint64)

    @staticmethod
    def _decode_rng_state(arr: np.ndarray) -> Dict[str, Any]:
        a = [int(x) for x in np.asarray(arr)]
        return {"bit_generator": "PCG64",
                "state": {"state": a[0] | (a[1] << 64), "inc": a[2] | (a[3] << 64)},
                "has_uint32": a[4], "uinteger": a[5]}

    def state_dict(self, destination: Optional[Dict] = None, prefix: str = "") -> Dict[str, Any]:
        destination = super().state_dict(destination, prefix)
        if self._any_persistent():
            # the mode marker (the fall-back to the copies is for good, so a fresh
            # instance may be in the other mode and is re-shaped at load), and the
            # resampling configuration, checked at load
            destination[prefix + "_use_vmap"] = np.asarray(self._use_vmap)
            destination[prefix + "_num_bootstraps"] = np.asarray(self.num_bootstraps)
            destination[prefix + "_sampling_strategy"] = np.asarray(self.sampling_strategy)
            if self._use_vmap:
                for k, v in self._stacked_state.items():
                    destination[f"{prefix}_stacked_state.{k}"] = v.detach().clone()
            encoded = self._encode_rng_state(self._rng)
            if encoded is not None:
                destination[prefix + "_rng_state"] = encoded
        return destination

    def load_state_dict(
        self, state_dict: Dict[str, Any], prefix: str = "", strict: bool = True, _consumed: Optional[set] = None
    ) -> None:
        owns_check = _consumed is None
        consumed: set = set() if owns_check else _consumed
        # the configuration first: a snapshot of another bootstrap count or
        # strategy is another estimator
        nb_key = prefix + "_num_bootstraps"
        if nb_key in state_dict:
            consumed.add(nb_key)
            ckpt_nb = int(np.asarray(state_dict[nb_key]))
            if ckpt_nb != self.num_bootstraps:
                raise ValueError(
                    f"BootStrapper checkpoint was written with num_bootstraps={ckpt_nb} but this"
                    f" instance has num_bootstraps={self.num_bootstraps}; construct the instance to"
                    " match the checkpoint"
                )
        ss_key = prefix + "_sampling_strategy"
        if ss_key in state_dict:
            consumed.add(ss_key)
            ckpt_ss = str(np.asarray(state_dict[ss_key]))
            if ckpt_ss != self.sampling_strategy:
                raise ValueError(
                    f"BootStrapper checkpoint was written with sampling_strategy={ckpt_ss!r} but this"
                    f" instance has sampling_strategy={self.sampling_strategy!r}; construct the"
                    " instance to match the checkpoint"
                )
        mode_key = prefix + "_use_vmap"
        if mode_key in state_dict:
            consumed.add(mode_key)
        if mode_key in state_dict and bool(np.asarray(state_dict[mode_key])) != self._use_vmap:
            # re-shape to the snapshot's mode, as __init__'s branches build it
            self._use_vmap = bool(np.asarray(state_dict[mode_key]))
            if self._use_vmap:
                self.metrics = []
                self._stacked_state = self._init_stacked_state()
            else:
                self.metrics = [deepcopy(self.base_metric) for _ in range(self.num_bootstraps)]
        super().load_state_dict(state_dict, prefix, strict, _consumed=consumed)
        if self._use_vmap:
            for k in list(self._stacked_state):
                name = f"{prefix}_stacked_state.{k}"
                if name in state_dict:
                    consumed.add(name)
                    self._stacked_state[k] = _as_state_tensor(state_dict[name], self.base_metric.device)
                elif strict and self.base_metric._persistent.get(k, False):
                    raise KeyError(f"Missing key {name} in state_dict")
        rng_key = prefix + "_rng_state"
        if rng_key in state_dict:
            consumed.add(rng_key)
            self._rng.bit_generator.state = self._decode_rng_state(state_dict[rng_key])
        elif strict and self._any_persistent():
            # without the generator's state a resume diverges in its later draws
            raise KeyError(f"Missing key {rng_key} in state_dict")
        if owns_check and strict:
            _raise_on_unconsumed(state_dict, prefix, consumed)
