"""What ``axis_name`` names in the port: the process group a device
collective runs over.

The JAX package names mesh axes inside ``shard_map``. The port takes a
``torch.distributed.ProcessGroup``, or a string or tuple of strings naming
dimensions of a ``torch.distributed.device_mesh.DeviceMesh`` (built with
``init_device_mesh(..., mesh_dim_names=("dp", "sp"))``) installed with
:func:`use_mesh`::

    mesh = init_device_mesh("cuda", (dp, sp), mesh_dim_names=("dp", "sp"))
    with use_mesh(mesh):
        state = metric.sync_state(state, "dp")
        value = metric.compute_from(local_state, axis_name=("dp", "sp"))

A tuple of names gathers in the row-major order of those dimensions, in the
order named, as the JAX package's ``lax.all_gather`` over several mesh axes
does; it needs one process group per slice of the mesh over the named
dimensions, which the first use creates on every rank (``dist.new_group``, a
collective call every rank must reach in the same order) and keeps until the
default process group changes.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

AxisName = Union[str, Tuple[str, ...], Any]

__all__ = ["AxisName", "resolve_axis", "use_mesh"]

_MESHES = threading.local()
# (id(mesh), names) -> (mesh, group, order): the mesh is held so its id is not reused
_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Tuple[Any, Any, Optional[List[int]]]] = {}
_GROUPS_WORLD: List[Any] = [None]  # the default group the cache was filled under
_GROUPS_LOCK = threading.Lock()


class use_mesh:
    """Context manager: string ``axis_name`` values name dimensions of
    ``mesh`` inside the block (this thread; blocks nest)."""

    def __init__(self, mesh: Any) -> None:
        self._mesh = mesh

    def __enter__(self) -> Any:
        stack = _MESHES.__dict__.setdefault("stack", [])
        stack.append(self._mesh)
        return self._mesh

    def __exit__(self, *exc: Any) -> None:
        _MESHES.stack.pop()


def _current_mesh() -> Any:
    stack = getattr(_MESHES, "stack", None)
    return stack[-1] if stack else None


def _mesh_group(mesh: Any, names: Tuple[str, ...]) -> Tuple[Any, Optional[List[int]]]:
    dist = torch.distributed
    key = (id(mesh), names)
    with _GROUPS_LOCK:
        if _GROUPS_WORLD[0] is not dist.group.WORLD:  # a new world: the old one's groups are destroyed
            _GROUPS.clear()
            _GROUPS_WORLD[0] = dist.group.WORLD
        hit = _GROUPS.get(key)
        if hit is not None and hit[0] is mesh:
            return hit[1], hit[2]
        dim_names = tuple(mesh.mesh_dim_names or ())
        if len(set(names)) != len(names) or any(n not in dim_names for n in names):
            raise ValueError(f"axis_name {names} must name distinct dimensions of the mesh {dim_names}")
        layout = mesh.mesh
        dims = [dim_names.index(n) for n in names]
        rest = [d for d in range(layout.ndim) if d not in dims]
        # one column per slice of the mesh over the named dims, its rows in the
        # row-major order of the named dims as named
        cols = layout.permute(*dims, *rest).reshape(math.prod(layout.shape[d] for d in dims), -1)
        me = dist.get_rank()
        group, want = None, None
        if len(names) == 1:
            group = mesh.get_group(names[0])
            want = next(c for c in cols.t().tolist() if me in c)
        else:
            for column in cols.t().tolist():
                g = dist.new_group(ranks=column)  # every rank creates every slice's group, in order
                if me in column:
                    group, want = g, column
        have = [dist.get_global_rank(group, i) for i in range(dist.get_world_size(group))]
        order = None if have == want else [have.index(r) for r in want]
        _GROUPS[key] = (mesh, group, order)
        return group, order


def resolve_axis(axis_name: AxisName) -> Tuple[Any, Optional[List[int]]]:
    """``(process_group, order)`` for ``axis_name``: ``order`` lists, for each
    position of the named axes' row-major order, the group rank at that
    position (``None`` where the two agree)."""
    if isinstance(axis_name, str):
        axis_name = (axis_name,)
    if isinstance(axis_name, tuple) and axis_name and all(isinstance(n, str) for n in axis_name):
        mesh = _current_mesh()
        if mesh is None:
            raise ValueError(
                f"axis_name {axis_name!r} names mesh dimensions, but no DeviceMesh is in use: "
                "run the call inside metrics_tpu_torch.parallel.sync.use_mesh(mesh)"
            )
        return _mesh_group(mesh, axis_name)
    if isinstance(axis_name, torch.distributed.ProcessGroup):
        return axis_name, None
    raise TypeError(
        f"axis_name must be a torch.distributed ProcessGroup or mesh dimension name(s), got {axis_name!r}"
    )
