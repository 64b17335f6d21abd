"""MetricCollection: a dict of metrics with shared-state compute groups
(port of ``metrics_tpu/collections.py``).

Compute groups: metrics whose updates produce identical states (e.g.
MulticlassPrecision/Recall/F1 over the same stat scores) are seeded into one
group at construction when they are structurally identical, and the remaining
group leaders are compared by value after the first update. From then on only
a group's leader updates, and its members alias the leader's states. A tensor
state can be shared because no update writes into a state in place (updates
rebind); a list ("cat") state is shared as one list object, which only the
leader appends to. The deepcopy in ``items()`` and friends keeps copy-on-read
semantics for callers that hold on to a member.

Not ported yet: ``save``/``restore`` (they wait for the checkpoint format).
"""

from __future__ import annotations

from collections import OrderedDict
from copy import deepcopy
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.metric import Metric, _cached_graphed_updater, _raise_on_unconsumed
from metrics_tpu_torch.obs import instrument as _obs
from metrics_tpu_torch.utils.data import _flatten_dict
from metrics_tpu_torch.utils.device import DeviceLike
from metrics_tpu_torch.utils.prints import rank_zero_warn

# np.allclose's defaults, the JAX package's test of equal states
_RTOL, _ATOL = 1e-5, 1e-8
_ARRAY_LIKE = (Tensor, np.ndarray, np.generic)


def _equal_arrays(a: Any, b: Any) -> bool:
    """Both tensors (or both numpy) of one shape, dtype and device, equal
    element for element. ``torch.equal`` reads one bool: a bare ``a == b`` on
    a tensor of several elements has no truth value."""
    if isinstance(a, Tensor) and isinstance(b, Tensor):
        return (a.shape, a.dtype, a.device) == (b.shape, b.dtype, b.device) and torch.equal(a, b)
    if isinstance(a, (np.ndarray, np.generic)) and isinstance(b, (np.ndarray, np.generic)):
        return a.shape == b.shape and a.dtype == b.dtype and bool(np.array_equal(a, b))
    return False


class MetricCollection:
    """Dict of metrics with a single update/forward/compute/reset.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MetricCollection
        >>> from metrics_tpu_torch.classification import MulticlassAccuracy, MulticlassF1Score
        >>> collection = MetricCollection([MulticlassAccuracy(3, device="cpu"), MulticlassF1Score(3, device="cpu")])
        >>> preds = torch.tensor([0, 2, 1, 2])
        >>> target = torch.tensor([0, 1, 1, 2])
        >>> collection.update(preds, target)
        >>> {k: round(float(v), 4) for k, v in collection.compute().items()}
        {'MulticlassAccuracy': 0.8333, 'MulticlassF1Score': 0.7778}
    """

    _modules: "OrderedDict[str, Metric]"

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        compute_groups: Union[bool, List[List[str]]] = True,
    ) -> None:
        self._modules = OrderedDict()
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        self._enable_compute_groups = compute_groups
        self._groups_checked: bool = False
        self._state_is_copy: bool = False
        self._groups: Dict[int, List[str]] = {}

        self.add_metrics(metrics, *additional_metrics)

    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    # ------------------------------------------------------------------ construction

    def add_metrics(
        self, metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]], *additional_metrics: Metric
    ) -> None:
        """Add metrics; a live collection's groups are formed anew."""
        if self._modules and getattr(self, "_groups_checked", False):
            # Adding to a live collection invalidates the group structure.
            # Break state aliasing FIRST: list ('cat') states are shared by
            # object between leader and members, and once the rebuilt groups
            # split a former group both ex-members would append into the one
            # shared list, double-counting every subsequent batch.
            self._compute_groups_create_state_ref(copy=True)
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence) and not isinstance(metrics, dict):
            metrics = list(metrics)
            remain: list = []
            for m in additional_metrics:
                (metrics if isinstance(m, Metric) else remain).append(m)
            if remain:
                rank_zero_warn(
                    f"You have passed extra arguments {remain} which are not `Metric` so they will be ignored.",
                    UserWarning,
                )
        elif additional_metrics:
            raise ValueError(
                f"You have passed extra arguments {additional_metrics} which are not compatible with first passed"
                " dictionary."
            )

        if isinstance(metrics, dict):
            for name in sorted(metrics.keys()):
                metric = metrics[name]
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"Value {metric} belonging to key {name} is not an instance of"
                        " `metrics_tpu_torch.Metric` or `metrics_tpu_torch.MetricCollection`"
                    )
                if isinstance(metric, Metric):
                    self._modules[name] = metric
                else:
                    for k, v in metric.items(keep_base=False):
                        self._modules[f"{name}_{k}"] = v
        elif isinstance(metrics, Sequence):
            for metric in metrics:
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"Input {metric} to `MetricCollection` is not a instance of"
                        " `metrics_tpu_torch.Metric` or `metrics_tpu_torch.MetricCollection`"
                    )
                if isinstance(metric, Metric):
                    name = metric.__class__.__name__
                    if name in self._modules:
                        raise ValueError(f"Encountered two metrics both named {name}")
                    self._modules[name] = metric
                else:
                    for k, v in metric.items(keep_base=False):
                        self._modules[k] = v
        else:
            raise ValueError("Unknown input to MetricCollection.")

        self._groups_checked = False
        if self._enable_compute_groups:
            self._init_compute_groups()
        else:
            self._groups = {i: [name] for i, name in enumerate(self._modules)}

    def _init_compute_groups(self) -> None:
        """Initialise compute groups: the explicit lists, or the structural seeding."""
        if isinstance(self._enable_compute_groups, list):
            self._groups = {i: v for i, v in enumerate(self._enable_compute_groups)}
            for v in self._groups.values():
                for metric in v:
                    if metric not in self._modules:
                        raise ValueError(
                            f"Input {metric} in `compute_groups` argument does not match a metric in the collection."
                        )
            self._groups_checked = True
        else:
            # Structural fast path: metrics sharing the same update code, the same non-state config, and the same state
            # spec provably evolve identical states (update is a pure function
            # of config, inputs and prior state), so they are seeded into one
            # group here and the runtime value comparison
            # (_merge_compute_groups) only has to arbitrate the remaining
            # leaders — e.g. metrics of different classes whose states happen
            # to coincide in value. Seeding is
            # strictly a subset of what the runtime comparison would merge, so
            # group membership is the same as without it; only the number of
            # first-update comparisons shrinks.
            if any(m._update_count for m in self._modules.values()):
                # add_metrics after real updates: a virgin metric can be
                # structurally identical to one that already carries history,
                # and seeding them together would alias that history onto the
                # newcomer. Let the runtime value merge arbitrate everything.
                self._groups = {i: [name] for i, name in enumerate(self._modules)}
                return
            groups: List[List[str]] = []
            for name in self._modules:
                m = self._modules[name]
                for g in groups:
                    if self._structurally_identical(self._modules[g[0]], m):
                        g.append(name)
                        break
                else:
                    groups.append([name])
            self._groups = dict(enumerate(groups))

    # Class-level names that provably cannot influence ``update``'s state
    # evolution: readout (compute/plot), constructors (config differences they
    # create surface as instance attrs, compared below), and display metadata.
    _CLASS_ATTR_ALLOW = frozenset({
        "compute", "plot", "__init__", "__doc__", "__module__", "__qualname__",
        "__firstlineno__", "__static_attributes__", "__annotations__",
        "__abstractmethods__", "_abc_impl", "__parameters__", "__orig_bases__",
        "is_differentiable", "higher_is_better", "full_state_update",
        "plot_lower_bound", "plot_upper_bound", "plot_legend_name",
    })
    # Instance attrs owned by the Metric runtime, not by metric config. Unlike
    # the JAX package's, the device is config here (``_device`` is compared:
    # states on two devices are never aliased), and the obs instance label is
    # runtime (with obs on it would otherwise keep every pair apart).
    _INSTANCE_ATTR_SKIP = frozenset({
        "_defaults", "_persistent", "_reductions", "_update_count",
        "_computed", "_to_sync", "_should_unsync", "_cache",
        "_is_synced", "_update_called", "_forward_cache", "_batch_state",
        "update", "compute", "_obs_instance_label",
    })

    @classmethod
    def _update_compatible_classes(cls, c1: type, c2: type) -> bool:
        """Every class-level name below ``Metric`` that could feed ``update``
        (helpers, properties, constants — e.g. the ``BLEUScore._tokenizer``
        property that ``SacreBLEUScore`` overrides) must resolve to the SAME
        object on both classes; readout/metadata names are exempt. Equal-but-
        distinct objects fail — a false negative only costs a runtime
        comparison."""
        if c1 is c2:
            return True
        names: set = set()
        for klass in (*c1.__mro__, *c2.__mro__):
            if klass is Metric:
                continue
            if issubclass(Metric, klass):  # ABC/object/Generic bases above Metric
                continue
            names.update(vars(klass))
        sentinel = object()
        return all(
            getattr(c1, n, sentinel) is getattr(c2, n, sentinel)
            for n in names
            if n not in cls._CLASS_ATTR_ALLOW
        )

    @classmethod
    def _structurally_identical(cls, m1: Metric, m2: Metric) -> bool:
        """True only when ``m1`` and ``m2`` provably produce equal states.

        Criteria: identical ``update`` function (class-level, not the
        per-instance forward wrapper), update-compatible classes (every
        non-readout class attribute the same object — catches inherited
        ``update`` calling an overridden helper), non-empty identical state
        specs (names, list-vs-tensor kind, default shapes/dtypes/devices/values,
        reduce fx) and equal config attributes INCLUDING ``_``-prefixed ones
        (only runtime machinery is skipped). Callable config that is not the
        same object (a Metric is callable) is conservatively treated as
        different, and so is anything unrecognisable — a false negative only
        costs a runtime comparison.
        """
        if type(m1).update is not type(m2).update:
            return False
        if not cls._update_compatible_classes(type(m1), type(m2)):
            return False
        if len(m1._defaults) == 0 or m1._defaults.keys() != m2._defaults.keys():
            return False
        for key in m1._defaults:
            d1, d2 = m1._defaults[key], m2._defaults[key]
            r1 = getattr(m1, "_reductions", {}).get(key)
            r2 = getattr(m2, "_reductions", {}).get(key)
            if r1 is not r2 and r1 != r2:
                return False
            if isinstance(d1, list) or isinstance(d2, list):
                if not (isinstance(d1, list) and isinstance(d2, list) and d1 == d2):
                    return False
                continue
            if not _equal_arrays(d1, d2):
                return False
        skip = set(m1._defaults) | cls._INSTANCE_ATTR_SKIP
        keys1 = {k for k in m1.__dict__ if k not in skip}
        keys2 = {k for k in m2.__dict__ if k not in skip}
        if keys1 != keys2:
            return False
        for k in keys1:
            a, b = m1.__dict__[k], m2.__dict__[k]
            if a is b:
                continue
            if isinstance(a, _ARRAY_LIKE) or isinstance(b, _ARRAY_LIKE):
                if not _equal_arrays(a, b):
                    return False
                continue
            # before ``==``: a Metric is callable, and its ``==`` builds a truthy CompositionalMetric
            if callable(a) or callable(b):
                return False
            try:
                if not bool(a == b):
                    return False
            except Exception:  # noqa: BLE001 — uncomparable config: keep apart
                return False
        return True

    # ------------------------------------------------------------------ dict protocol

    def keys(self, keep_base: bool = False) -> Iterable[str]:
        if keep_base:
            return self._modules.keys()
        return [self._set_name(k) for k in self._modules.keys()]

    def items(self, keep_base: bool = False, copy_state: bool = True) -> Iterable[Tuple[str, Metric]]:
        self._compute_groups_create_state_ref(copy_state)
        if keep_base:
            return self._modules.items()
        return [(self._set_name(k), v) for k, v in self._modules.items()]

    def values(self, copy_state: bool = True) -> Iterable[Metric]:
        self._compute_groups_create_state_ref(copy_state)
        return self._modules.values()

    def __getitem__(self, key: str, copy_state: bool = True) -> Metric:
        self._compute_groups_create_state_ref(copy_state)
        return self._modules[key]

    def __len__(self) -> int:
        return len(self._modules)

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def __contains__(self, key: str) -> bool:
        return key in self._modules or key in list(self.keys())

    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        name = name if self.postfix is None else name + self.postfix
        return name

    # ------------------------------------------------------------------ metric API

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update each metric once per compute group.

        Only group leaders update, in the formation round too: structurally
        seeded members provably evolve the leader's state, and their own
        first-update state would be discarded at the next
        _compute_groups_create_state_ref anyway, so the formation round skips
        the member updates and the value merge arbitrates the remaining
        leaders.
        """
        # collection-level span: member updates nest under it in the trace, so a
        # Perfetto view shows which member dominates the collection's wall time
        with _obs.metric_op("update", self):
            for cg in self._groups.values():
                m0 = self._modules[cg[0]]
                m0.update(*args, **m0._filter_kwargs(**kwargs))
        if self._groups_checked:
            if self._state_is_copy:
                # If a copy was made, the aliasing is broken — restore it
                self._compute_groups_create_state_ref(copy=False)
                self._state_is_copy = False
        else:
            if self._enable_compute_groups and not isinstance(self._enable_compute_groups, list):
                self._merge_compute_groups()
            self._groups_checked = True

    def _merge_compute_groups(self) -> None:
        """O(n²) pairwise state comparison of the group leaders → merged groups."""
        num_groups = len(self._groups)
        while True:
            for cg_idx1, cg_members1 in deepcopy(self._groups).items():
                for cg_idx2, cg_members2 in deepcopy(self._groups).items():
                    if cg_idx1 == cg_idx2:
                        continue
                    metric1 = self._modules[cg_members1[0]]
                    metric2 = self._modules[cg_members2[0]]
                    if self._equal_metric_states(metric1, metric2):
                        self._groups[cg_idx1].extend(self._groups.pop(cg_idx2))
                        break
                else:
                    continue
                break
            else:
                break
            if len(self._groups) == num_groups:
                break
            num_groups = len(self._groups)

        # Re-index
        self._groups = {i: v for i, v in enumerate(self._groups.values())}

    @staticmethod
    def _equal_metric_states(metric1: Metric, metric2: Metric) -> bool:
        """Shape, dtype and device, then closeness (``np.allclose``'s rtol and
        atol, NaN unequal) of all states.

        The closeness tests stay on the states' device and are combined there;
        the result is read once, the one host sync per pair of leaders in the
        round that forms the groups.
        """
        if len(metric1._defaults) == 0 or len(metric2._defaults) == 0:
            return False
        if metric1._defaults.keys() != metric2._defaults.keys():
            return False
        pairs = []
        for key in metric1._defaults:
            state1 = getattr(metric1, key)
            state2 = getattr(metric2, key)
            if isinstance(state1, Tensor) and isinstance(state2, Tensor):
                pairs.append((state1, state2))
            elif isinstance(state1, list) and isinstance(state2, list):
                if len(state1) != len(state2):
                    return False
                pairs.extend(zip(state1, state2))
            else:
                # mixed or unrecognised state kinds: never group on a guess
                return False
        if not all(
            isinstance(a, Tensor) and isinstance(b, Tensor)
            and (a.shape, a.dtype, a.device) == (b.shape, b.dtype, b.device)
            for a, b in pairs
        ):
            return False
        close = [torch.isclose(a, b, rtol=_RTOL, atol=_ATOL).all() for a, b in pairs]
        return bool(torch.stack(close).all()) if close else True

    def _compute_groups_create_state_ref(self, copy: bool = False) -> None:
        """Alias (or deepcopy) leader states onto group members."""
        if self._groups_checked:
            for cg in self._groups.values():
                m0 = self._modules[cg[0]]
                for name in cg[1:]:
                    mi = self._modules[name]
                    for state in m0._defaults:
                        m0_state = getattr(m0, state)
                        # alias the leader's state: updates rebind tensors, and only the leader appends to a list
                        setattr(mi, state, deepcopy(m0_state) if copy else m0_state)
                    mi._update_count = deepcopy(m0._update_count) if copy else m0._update_count
                    mi._update_called = m0._update_called
                    # the member's compute cache predates the refreshed state
                    mi._computed = None
        self._state_is_copy = copy

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Per-batch value from every metric.

        Once compute groups are known, each group runs ONE forward (the
        leader's) and members derive their batch value from the leader's
        stashed batch-only state via their own ``compute``
        (`Metric._compute_batch_value`): one update per group. Groups form in
        ``update`` only, never in ``forward``.
        """
        if self._groups_checked:
            by_name: Dict[str, Any] = {}
            for cg in self._groups.values():
                m0 = self._modules[cg[0]]
                by_name[cg[0]] = m0(*args, **m0._filter_kwargs(**kwargs))
                for name in cg[1:]:
                    mi = self._modules[name]
                    if m0._batch_state is not None:
                        by_name[name] = mi._compute_batch_value(m0._batch_state)
                    else:
                        # leader's forward didn't stash a batch state (custom
                        # forward override): member pays its own forward
                        by_name[name] = mi(*args, **mi._filter_kwargs(**kwargs))
            if self._state_is_copy:
                self._compute_groups_create_state_ref(copy=False)
                self._state_is_copy = False
            res = {k: by_name[k] for k in self._modules}
        else:
            res = {k: m(*args, **m._filter_kwargs(**kwargs)) for k, m in self._modules.items()}
        res, _ = _flatten_dict(res)
        return {self._set_name(k): v for k, v in res.items()}

    def __call__(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        return self.forward(*args, **kwargs)

    def compute(self) -> Dict[str, Any]:
        """Compute every metric (group members see the leader's synced state)."""
        with _obs.metric_op("compute", self):
            self._compute_groups_create_state_ref()
            res = {k: m.compute() for k, m in self._modules.items()}
        res, _ = _flatten_dict(res)
        return {self._set_name(k): v for k, v in res.items()}

    def reset(self) -> None:
        for m in self._modules.values():
            m.reset()
        if self._enable_compute_groups and not isinstance(self._enable_compute_groups, list):
            # reset group detection: states are all equal (defaults) again
            self._groups_checked = False
            self._init_compute_groups()

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        """Deep copy with optionally new prefix/postfix. A clone's members
        alias its own leaders' states, never the source's."""
        mc = deepcopy(self)
        if prefix is not None:
            mc.prefix = self._check_arg(prefix, "prefix")
        if postfix is not None:
            mc.postfix = self._check_arg(postfix, "postfix")
        return mc

    def persistent(self, mode: bool = True) -> None:
        for m in self._modules.values():
            m.persistent(mode)

    def state_dict(self, destination: Optional[Dict[str, Any]] = None, prefix: str = "") -> Dict[str, Any]:
        # group members may hold never-updated default states (only leaders
        # update) — refresh the aliasing so persistent states serialize with
        # their group's real values. destination/prefix mirror Metric's
        # signature so wrappers (MetricTracker) can nest collections.
        self._compute_groups_create_state_ref()
        destination = {} if destination is None else destination
        for name, m in self._modules.items():
            m.state_dict(destination, prefix=f"{prefix}{name}.")
        return destination

    def load_state_dict(
        self, state_dict: Dict[str, Any], prefix: str = "", strict: bool = True, _consumed: Optional[set] = None
    ) -> None:
        owns_check = _consumed is None
        consumed: set = set() if owns_check else _consumed
        for name, m in self._modules.items():
            m.load_state_dict(state_dict, prefix=f"{prefix}{name}.", strict=strict, _consumed=consumed)
        if owns_check and strict:
            _raise_on_unconsumed(state_dict, prefix, consumed)

    def save(self, path: str, *, policy: Any = None, meta: Optional[Dict[str, Any]] = None) -> None:
        """Persist the collection's FULL state (every member, every state) to
        ``path`` — atomic, checksummed, lossless by default. See
        :meth:`Metric.save`; group members serialize with their leader's real
        values (aliasing refreshed first, as in :meth:`state_dict`)."""
        from metrics_tpu_torch.ckpt import save as _ckpt_save

        _ckpt_save(self, path, policy=policy, meta=meta)

    def restore(self, path: str) -> Any:
        """Load a :meth:`save` snapshot into this collection (strict — see
        :meth:`Metric.restore`). Compute-group aliasing is re-established after
        the load: members point at their leader's freshly restored tensors,
        never at stale pre-restore state."""
        from metrics_tpu_torch.ckpt import restore as _ckpt_restore

        return _ckpt_restore(self, path)

    def to_device(self, device: DeviceLike) -> "MetricCollection":
        for m in self._modules.values():
            m.to_device(device)
        return self

    # ------------------------------------------------------------------ functional API

    def init_state(self) -> Dict[str, Any]:
        """One state per group leader once the groups are checked (form them
        with one eager ``update``); one per metric before."""
        if not self._groups_checked and self._enable_compute_groups:
            # without data we can't value-compare; fall back to per-metric states
            return {name: m.init_state() for name, m in self._modules.items()}
        return {cg[0]: self._modules[cg[0]].init_state() for cg in self._groups.values()}

    def update_state(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Pure: one ``update_state`` per entry of ``state`` (per group leader
        once the groups are checked)."""
        new_state = {}
        for name, sub in state.items():
            m = self._modules[name]
            new_state[name] = m.update_state(sub, *args, **m._filter_kwargs(**kwargs))
        return new_state

    def merge_states(self, state_a: Dict[str, Any], state_b: Dict[str, Any]) -> Dict[str, Any]:
        """Associatively merge two collection state dicts, per member metric.

        The collection analogue of :meth:`Metric.merge_states` — the streaming
        engine's sliding windows and cross-shard folds need it for collections too.
        States are keyed as ``init_state`` produced them (per metric, or per group
        leader once groups are known).
        """
        return {name: self._modules[name].merge_states(state_a[name], state_b[name]) for name in state_a}

    def jitted_update_state(self, donate: bool = True) -> Any:
        """The whole collection update captured as ONE CUDA graph per operand
        shape and dtype (engine hook): every group leader's update replays in one
        graph launch. Donation as in :meth:`Metric.jitted_update_state`."""
        return _cached_graphed_updater(self, donate)

    def sync_state(self, state: Dict[str, Any], axis_name: Any) -> Dict[str, Any]:
        """Pure: every member's (or group leader's) state synced over
        ``axis_name`` by its own :meth:`Metric.sync_state`, keyed as ``state`` is."""
        return {name: self._modules[name].sync_state(sub, axis_name) for name, sub in state.items()}

    def compute_from(self, state: Dict[str, Any], axis_name: Optional[Any] = None) -> Dict[str, Any]:
        """Pure compute for all metrics from the (group-deduped) state dict;
        ``axis_name`` syncs each member's state first, as
        :meth:`Metric.compute_from` does."""
        leader_of = {}
        for cg in self._groups.values():
            for name in cg:
                leader_of[name] = cg[0] if cg[0] in state else name
        res = {}
        for name, m in self._modules.items():
            sub = state.get(name, state.get(leader_of.get(name, name)))
            res[name] = m.compute_from(sub, axis_name=axis_name)
        res, _ = _flatten_dict(res)
        return {self._set_name(k): v for k, v in res.items()}

    @property
    def compute_groups(self) -> Dict[int, List[str]]:
        return self._groups

    def __getstate__(self) -> Dict[str, Any]:
        # captured updaters neither pickle nor deepcopy (a clone captures its
        # own); the obs instance label is dropped so a clone gets its own
        # telemetry series instead of aliasing its source's
        return {k: v for k, v in self.__dict__.items() if k not in ("_jitted_update_state", "_obs_instance_label")}

    def __repr__(self) -> str:
        repr_str = self.__class__.__name__ + "(\n"
        for name, m in self._modules.items():
            repr_str += f"  ({name}): {m!r}\n"
        if self.prefix:
            repr_str += f"  prefix={self.prefix}\n"
        if self.postfix:
            repr_str += f"  postfix={self.postfix}\n"
        return repr_str + ")"
