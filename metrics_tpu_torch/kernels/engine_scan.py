"""The engine's bucket-masked scan — reference and fused bodies
(port of ``metrics_tpu/kernels/engine_scan.py``).

``StreamingEngine``'s micro-batch kernels (engine/runtime.py ``_build_kernel``)
walk the coalesced micro-batch rows over the stacked multi-tenant slab, applying
the metric's own ``update_state`` to each row in order. The **reference** body
makes two passes over the addressed tenant slice per row: compute the update,
then ``where``-select the pre-update state back for masked (padding) rows before
scattering. The **fused** body folds the mask into the scatter *address*
instead: the slab is extended by one scratch row, a masked row's (discarded)
update lands there, and every real row scatters ``update_state``'s result
directly. Real rows see bit-identical arithmetic (the same ``update_state`` on
the same state in the same order; masked rows touch only the scratch row,
which is dropped when the extended slab is copied back).

Both bodies are plain PyTorch loops over the bucket's rows, and both write the
slab's tensors in place, so that a CUDA graph captured around one call replays
into the engine's slab (the counterpart of the JAX package donating it). There
is no hand kernel here: the body is any metric's ``update_state``. What runs on
the card inside it are the port's hand kernels (``csrc/pair_count.cu``,
``scatter.cu``, ``cms_walk.cu``, ``binned_curve.cu``), as the metric calls them.

Gathers and scatters index with slot ids (``index_select`` / ``index_copy_``
with a one-element index tensor, no host read), never with a user value: slots
and the scratch row are in range by construction, whereas an index out of range
would raise (on the card, as a device-side assert that ends the context) where
the JAX package's gather clamps.

Selection is static per (bucket, capacity) and the same on every device: the
fused body when the micro-batch is at least as tall as the tenant stack
(``bucket >= capacity``: the saved per-row selects outweigh the scratch-row
copies), the reference otherwise. Unlike a hand kernel's plain version, the
reference body is no CPU-only stand-in: both bodies are ordinary torch code
and both run on the card.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
from torch import Tensor
from torch.utils._pytree import tree_flatten, tree_unflatten

from metrics_tpu_torch.kernels import registry
from metrics_tpu_torch.obs import instrument as _obs

ENTRY = "engine_masked_scan"


def leaves_like(tree: Any, spec: Any) -> list:
    """``tree``'s leaves, which must be laid out as ``spec`` (the same dict keys in
    the same order): a state's leaves are matched to the slab's by position."""
    leaves, got = tree_flatten(tree)
    if got != spec:
        raise ValueError(f"a state laid out as {got} does not match the slab's layout {spec}")
    return leaves


def _reference_scan(
    update_state: Callable,
    stacked: Any,
    key_ids: Tensor,
    mask: Tensor,
    columns: Sequence[Tensor],
) -> Any:
    """Two-pass body: update, where-select masked rows back, scatter. Writes
    ``stacked`` in place and returns it."""
    leaves, spec = tree_flatten(stacked)
    kids = key_ids.to(torch.int64)
    for i in range(kids.shape[0]):
        kid = kids[i : i + 1]
        old = [leaf.index_select(0, kid)[0] for leaf in leaves]
        new = leaves_like(update_state(tree_unflatten(old, spec), *(c[i] for c in columns)), spec)
        keep = mask[i]
        for leaf, n, o in zip(leaves, new, old):
            leaf.index_copy_(0, kid, torch.where(keep, n.to(leaf.dtype), o).unsqueeze(0))
    return stacked


def _fused_scan(
    update_state: Callable,
    stacked: Any,
    key_ids: Tensor,
    mask: Tensor,
    columns: Sequence[Tensor],
) -> Any:
    """One-pass body: masked rows scatter into a scratch row at index ``capacity``.
    Writes ``stacked`` in place and returns it."""
    leaves, spec = tree_flatten(stacked)
    capacity = leaves[0].shape[0]
    ext = [torch.cat([leaf, torch.zeros_like(leaf[:1])], dim=0) for leaf in leaves]
    # the mask becomes the scatter ADDRESS: real rows hit their tenant slot,
    # padding rows hit the scratch slot (whose garbage is never copied back)
    slots = torch.where(mask, key_ids.to(torch.int64), capacity)
    for i in range(slots.shape[0]):
        slot = slots[i : i + 1]
        per_key = [e.index_select(0, slot)[0] for e in ext]
        new = leaves_like(update_state(tree_unflatten(per_key, spec), *(c[i] for c in columns)), spec)
        for e, n in zip(ext, new):
            e.index_copy_(0, slot, n.to(e.dtype).unsqueeze(0))
    for leaf, e in zip(leaves, ext):
        leaf.copy_(e[:capacity])
    return stacked


def _eligible(bucket: int, capacity: int) -> bool:
    # the saved per-row selects must outweigh the scratch extend/copy-back
    return bucket >= capacity


def _entry_eligible(
    update_state: Callable,
    stacked: Any,
    key_ids: Tensor,
    mask: Tensor,
    columns: Sequence[Tensor],
) -> bool:
    """Registry-contract eligibility: the entry's call signature, the static
    bucket/capacity facts read from the shapes."""
    return _eligible(int(key_ids.shape[0]), int(tree_flatten(stacked)[0][0].shape[0]))


registry.register(
    registry.KernelEntry(name=ENTRY, reference=_reference_scan, optimized=_fused_scan, eligible=_entry_eligible)
)


def masked_scan_update(
    update_state: Callable,
    stacked: Any,
    key_ids: Tensor,
    mask: Tensor,
    columns: Sequence[Tensor],
) -> Any:
    """Run one micro-batch through the body its (bucket, capacity) selects.

    Not :func:`registry.dispatch`: that one keeps a reference for CPU tensors,
    and here both bodies serve every device (module docstring). The dispatch
    record is counted the same way.
    """
    entry = registry.get(ENTRY)
    impl = "optimized" if entry.eligible(update_state, stacked, key_ids, mask, columns) else "reference"
    _obs.record_kernel_dispatch(ENTRY, impl)
    fn = entry.optimized if impl == "optimized" else entry.reference
    return fn(update_state, stacked, key_ids, mask, columns)
