"""Query reports — where a global answer came from, and what it is missing
(port of ``metrics_tpu/query/report.py``).

The honesty contract in one object: every partition that contributed is
listed with the node that served it, whether that node was a follower, its
``(epoch, seq)`` watermark, and its staleness evidence; every partition that
did NOT contribute is *named* in ``partitions_missing`` with the refusal
that excluded it. A degraded answer is therefore an agreed, named subset —
never a silent undercount.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Optional, Tuple

__all__ = ["GlobalResult", "PartitionReport", "QueryReport"]


@dataclass(frozen=True)
class PartitionReport:
    """One partition's contribution to (or absence from) a global answer."""

    partition: str
    node: str = ""
    follower: bool = False
    watermark: Optional[Tuple[int, int]] = None
    tenants: int = 0
    staleness_seqs: Optional[int] = None
    staleness_s: Optional[float] = None
    error: str = ""  # why it is missing ("" when it contributed)

    @property
    def missing(self) -> bool:
        return self.watermark is None


@dataclass(frozen=True)
class QueryReport:
    """Provenance of one global query answer."""

    op: str
    partitions: Tuple[PartitionReport, ...] = ()
    partitions_missing: Tuple[str, ...] = ()
    watermarks: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    cache_hit: bool = False
    merge_hops: int = 0
    tenants: int = 0

    @property
    def degraded(self) -> bool:
        """True when the answer covers a strict live subset of the fleet."""
        return bool(self.partitions_missing)

    @property
    def follower_served(self) -> bool:
        """True when NO contributing rollup touched a write leader."""
        served = [p for p in self.partitions if not p.missing]
        return bool(served) and all(p.follower for p in served)


@dataclass(frozen=True)
class GlobalResult:
    """``value`` + ``report``; unpacks like a pair for ergonomic call sites:
    ``value, report = gq.quantile(metric, 0.99)``."""

    value: Any
    report: QueryReport

    def __iter__(self) -> Iterator[Any]:
        yield self.value
        yield self.report
