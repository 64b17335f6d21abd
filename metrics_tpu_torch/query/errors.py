"""Query-plane error types (port of ``metrics_tpu/query/errors.py``)."""

from __future__ import annotations

from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

__all__ = ["NoLivePartitionsError", "PartialResultError", "RollupUnsupported"]


class RollupUnsupported(MetricsTPUUserError):
    """The metric carries a state a rollup cannot fold.

    A partition rollup is a FIXED-SIZE mergeable summary — one state pytree
    the shape of a single tenant's, standing in for all of them. States with
    ``dist_reduce_fx`` of ``'cat'`` or ``None`` grow with the stream (raw
    sample lists, per-example arrays), so folding a million tenants' worth
    would reconstruct the stream, not summarize it. Use a sketch-family
    metric (DDSketch / HLL / CMS) or a reducible scalar state instead.
    """


class NoLivePartitionsError(MetricsTPUUserError):
    """Every partition was unreachable: there is no subset to degrade to.

    A global query degrades to a *named* live subset when SOME partitions
    are missing; with none contributing, any value would be fabricated.
    The message names every partition and why it failed.
    """


class PartialResultError(MetricsTPUUserError):
    """Raised instead of degrading when ``require_full=True`` and at least
    one partition is missing — for callers whose answer is only meaningful
    over the whole fleet. The missing partitions are named."""
