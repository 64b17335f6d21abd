"""Hierarchical reduce — partition rollups merged through a multi-hop tree
(port of ``metrics_tpu/query/tree.py``).

Rollups merge level by level in a deterministic ``fan_in``-ary tree:
partition order is fixed (ascending partition id of whatever live subset
contributed), each level groups ``fan_in`` consecutive states, and each
group folds in ONE stacked reduction per leaf (:func:`fold_states` — the
same vectorised semantics as the per-partition fold, so a group merge is one
torch reduction / one ``topk_merge`` call, not ``fan_in - 1`` pairwise
ops). The topology is a pure function of ``(live subset, fan_in)``: every
querier, and the centralized oracle the property suite holds it to, merges
in the same shape.

For the exact reductions the sketch families use (integer sums, elementwise
min/max, register max, in-ledger top-k unions) the result is bit-identical
for ANY tree shape — the tree exists to bound peak stack width and to model
the multi-hop reduction a cross-host deployment runs over the comm plane's
transports, where each hop is one transfer.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

from metrics_tpu_torch.query.rollup import fold_states

__all__ = ["merge_tree"]


def merge_tree(
    metric: Any, states: Sequence[Dict[str, Any]], *, fan_in: int = 4
) -> Tuple[Dict[str, Any], int]:
    """Merge ``states`` through a ``fan_in``-ary tree.

    Returns ``(merged_state, hops)`` where ``hops`` is the number of tree
    levels reduced — 0 for a single state, ``ceil(log_fan_in(n))`` otherwise.
    An empty sequence returns the merge identity (``metric.init_state()``).
    """
    if int(fan_in) < 2:
        raise ValueError(f"`fan_in` must be >= 2, got {fan_in}")
    level: List[Dict[str, Any]] = list(states)
    if not level:
        return metric.init_state(), 0
    hops = 0
    while len(level) > 1:
        nxt: List[Dict[str, Any]] = []
        for i in range(0, len(level), int(fan_in)):
            group = level[i : i + int(fan_in)]
            nxt.append(group[0] if len(group) == 1 else fold_states(metric, group))
        level = nxt
        hops += 1
    return level[0], hops
