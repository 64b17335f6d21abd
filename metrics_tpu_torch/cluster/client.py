"""ClusterClient — leader-resolving request router with redirect + backoff
(port of ``metrics_tpu/cluster/client.py``).

The client side of the routing contract (the JAX package's
``docs/source/cluster.md``): resolve the
writable leader from the coordination store, send writes there, and treat
:class:`~metrics_tpu_torch.repl.errors.NotPrimaryError` /
:class:`~metrics_tpu_torch.repl.errors.StalenessExceeded` as *redirects*, not
failures — re-resolve and retry under capped exponential backoff (jittered),
because during a failover both are transient by design: the old leader
refuses writes the instant it steps down, and a follower refuses bounded
reads until it catches the new lineage. Only when the retry budget is
exhausted does the router raise
:class:`~metrics_tpu_torch.cluster.errors.NoLeaderError` — the caller's signal that
the cluster is genuinely headless, not merely mid-election.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Dict, Mapping, Optional

from metrics_tpu_torch.cluster.errors import CoordStoreError, NoLeaderError
from metrics_tpu_torch.cluster.store import CoordStore, Lease
from metrics_tpu_torch.engine.runtime import EngineClosed
from metrics_tpu_torch.repl.errors import NotPrimaryError, StalenessExceeded

__all__ = ["ClusterClient"]

# all three mean "this node cannot serve the request RIGHT NOW, someone else
# can": a stale leader resolution, a staleness-bounded replica mid-catch-up,
# or a dead node's handle (EngineClosed is the in-process analogue of an RPC
# stub's connection-refused — the lease may outlive the process by up to a
# TTL, and routing must survive that window)
_REDIRECTS = (NotPrimaryError, StalenessExceeded, EngineClosed)


class ClusterClient:
    """Route submits/reads to a cluster of engines by coordination-store lease.

    ``engines`` maps node id → engine handle (in-process engines here; a
    networked deployment substitutes RPC stubs with the same ``submit``/
    ``compute`` surface — the routing contract is identical). The resolved
    leader is cached and invalidated on the first redirect.

    Args:
        store: the cluster's :class:`~metrics_tpu_torch.cluster.store.CoordStore`.
        engines: node id → engine (or engine-shaped stub).
        retries: redirect/backoff attempts before :class:`NoLeaderError`.
        backoff_s / backoff_cap_s: capped exponential backoff (jittered ±50%).
        sleep: injectable for tests (defaults to ``time.sleep``).
        lease_reread_s: once a refresh read confirms the lease record is
            *unchanged* (same epoch), further refreshes within this window
            return the memo without touching the store — a flapping leader
            (refusing writes while still renewing its lease) would otherwise
            turn every redirect into a ``read_lease`` call.
    """

    def __init__(
        self,
        store: CoordStore,
        engines: Mapping[str, Any],
        *,
        retries: int = 8,
        backoff_s: float = 0.02,
        backoff_cap_s: float = 0.5,
        sleep: Callable[[float], None] = time.sleep,
        rng_seed: Optional[int] = None,
        lease_reread_s: float = 0.25,
    ) -> None:
        self._store = store
        self._engines = dict(engines)
        self._retries = int(retries)
        self._backoff_s = float(backoff_s)
        self._backoff_cap_s = float(backoff_cap_s)
        self._sleep = sleep
        self._rng = random.Random(rng_seed)
        self._cached_leader: Optional[str] = None
        self._lease_reread_s = float(lease_reread_s)
        # lease-epoch memo: the last lease we read, whether a refresh has
        # already confirmed its epoch unchanged, and when the skip window ends
        self._memo_lease: Optional[Lease] = None
        self._memo_validated = False
        self._memo_next_read_at = 0.0
        self.redirects = 0  # NotPrimary/Staleness bounces absorbed by routing

    # ------------------------------------------------------------------ resolve

    def leader_id(self, *, refresh: bool = False) -> Optional[str]:
        """The current lease holder's node id (None while headless)."""
        if self._cached_leader is not None and not refresh:
            return self._cached_leader
        if self._memo_lease is not None and self._memo_validated:
            # the record was already re-read once for this epoch and had not
            # moved; while it is unexpired there is nothing new to learn from
            # the store — retry the memoized holder (redirect storms under a
            # flapping-but-lease-holding leader must not hammer read_lease)
            try:
                now = self._store.now()
            except CoordStoreError:
                return None
            if not self._memo_lease.expired(now) and now < self._memo_next_read_at:
                self._cached_leader = self._memo_lease.holder
                return self._memo_lease.holder
        try:
            lease = self._store.read_lease()
        except CoordStoreError:
            return None
        if (
            lease is None
            or lease.expired(self._store.now())
            or lease.holder not in self._engines
        ):
            self._memo_lease = None
            self._memo_validated = False
            return None
        if self._memo_lease is not None and lease.epoch == self._memo_lease.epoch:
            self._memo_validated = True
            self._memo_next_read_at = self._store.now() + self._lease_reread_s
        else:
            self._memo_validated = False
        self._memo_lease = lease
        self._cached_leader = lease.holder
        return lease.holder

    def _invalidate(self) -> None:
        # drops the fast-path cache but keeps the epoch memo: the next
        # leader_id(refresh=True) decides whether the store needs a re-read
        self._cached_leader = None

    def _backoff(self, attempt: int) -> None:
        delay = min(self._backoff_s * (2.0 ** attempt), self._backoff_cap_s)
        self._sleep(delay * (0.5 + self._rng.random()))

    # ------------------------------------------------------------------ routing

    def submit(self, key: Any, *args: Any, **kwargs: Any) -> Any:
        """Route one write to the leader; redirect + backoff across failovers."""
        last: Optional[BaseException] = None
        for attempt in range(self._retries + 1):
            leader = self.leader_id(refresh=attempt > 0)
            if leader is None:
                self._backoff(attempt)
                continue
            try:
                return self._engines[leader].submit(key, *args, **kwargs)
            except (NotPrimaryError, EngineClosed) as exc:
                # stale resolution (the lease moved between our read and the
                # submit), a leader mid-step-down, or a dead node whose lease
                # hasn't expired yet: re-resolve and retry
                last = exc
                self.redirects += 1
                self._invalidate()
                self._backoff(attempt)
        raise NoLeaderError(
            f"no writable leader after {self._retries + 1} attempts "
            f"(last redirect: {type(last).__name__ if last else 'none resolved'})"
        )

    def compute(self, key: Any, *, prefer: str = "leader", **kwargs: Any) -> Any:
        """Route one read. ``prefer="leader"`` reads the writable truth;
        ``prefer="replica"`` tries a non-leader first (read scale-out) and
        redirects to the leader only when the replica refuses the staleness
        bound."""
        value, _node, _is_leader = self.call("compute", key, prefer=prefer, **kwargs)
        return value

    def call(
        self,
        op: str,
        *args: Any,
        prefer: str = "leader",
        retries: Optional[int] = None,
        **kwargs: Any,
    ) -> "tuple[Any, str, bool]":
        """Route one read-shaped method call under the same redirect ladder as
        :meth:`compute`, returning ``(result, node_id, served_by_leader)``.

        The provenance pair is what the query plane's honesty contract needs:
        a global rollup reports WHICH node served each partition and whether
        the read ever touched the write leader. ``retries`` overrides the
        router's budget (``0`` = one attempt) — cache-revalidation probes
        fall back to a re-merge rather than inherit the write path's patience.
        """
        if prefer not in ("leader", "replica"):
            raise ValueError(f"prefer must be 'leader' or 'replica', got {prefer!r}")
        budget = self._retries if retries is None else int(retries)
        last: Optional[BaseException] = None
        for attempt in range(budget + 1):
            leader = self.leader_id(refresh=attempt > 0)
            target = leader
            if prefer == "replica":
                replicas = [n for n in self._engines if n != leader]
                if replicas:
                    target = replicas[self._rng.randrange(len(replicas))]
            if target is None:
                self._backoff(attempt)
                continue
            try:
                return getattr(self._engines[target], op)(*args, **kwargs), target, target == leader
            except StalenessExceeded as exc:
                last = exc
                self.redirects += 1
                if prefer == "replica" and leader is not None:
                    try:
                        return getattr(self._engines[leader], op)(*args, **kwargs), leader, True
                    except _REDIRECTS as exc2:
                        last = exc2
                self._invalidate()
                self._backoff(attempt)
            except (NotPrimaryError, EngineClosed) as exc:
                last = exc
                self.redirects += 1
                self._invalidate()
                self._backoff(attempt)
        raise NoLeaderError(
            f"no engine could serve {op}() after {budget + 1} attempts "
            f"(last refusal: {type(last).__name__ if last else 'none resolved'})"
        )
