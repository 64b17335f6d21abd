"""GuardPlane — the one object the engine talks to; composes every policy
(port of ``metrics_tpu/guard/plane.py``).

Admission (``admit``) runs on the caller's thread at ``submit`` entry; drain
forming (``form_drain``) runs on the dispatcher between queue and kernels;
breaker gates wrap the three failure-prone dependencies (graph captures,
checkpoint commits, comm sync); outcome recording (``on_request_outcome``)
feeds the poison-tenant quarantine. Every decision is counted twice: in the
engine's always-on telemetry (closed counter set, flat snapshot) and — when
``obs`` is enabled — in the master-gated ``metrics_tpu_guard_*`` series.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List, Optional, Tuple

from metrics_tpu_torch.guard.breaker import (
    BREAKER_STATE_CODES,
    CircuitBreaker,
    CompileGovernor,
)
from metrics_tpu_torch.guard.config import GuardConfig
from metrics_tpu_torch.guard.errors import (
    DeadlineExceeded,
    QuotaExceeded,
    RequestShed,
    TenantQuarantined,
)
from metrics_tpu_torch.guard.fairness import FairBacklog, FifoBacklog
from metrics_tpu_torch.guard.quarantine import DENY, PROBE, TenantQuarantine
from metrics_tpu_torch.guard.quota import TenantQuotas
from metrics_tpu_torch.guard.shed import CoDelShedder
from metrics_tpu_torch.obs import instrument as _obs

__all__ = ["GuardPlane"]


class GuardPlane:
    def __init__(self, cfg: GuardConfig, *, telemetry: Any, max_rows: int) -> None:
        self.cfg = cfg
        self.clock = cfg.clock
        self._telemetry = telemetry
        self._engine_label = getattr(telemetry, "engine_id", "0")
        self.quotas = TenantQuotas(
            cfg.quota_rows_per_s, cfg.quota_burst_rows, cfg.tenant_quotas, cfg.clock
        )
        self.shedder = (
            CoDelShedder(cfg.shed_target_s, cfg.shed_interval_s, cfg.clock) if cfg.shed else None
        )
        self.quarantine = TenantQuarantine(
            threshold=cfg.quarantine_threshold,
            probation_s=cfg.quarantine_probation_s,
            probation_max_s=cfg.quarantine_probation_max_s,
            probation_factor=cfg.quarantine_probation_factor,
            clock=cfg.clock,
        )

        def _breaker(name: str) -> CircuitBreaker:
            return CircuitBreaker(
                name,
                failure_threshold=cfg.breaker_failure_threshold,
                probation_s=cfg.breaker_probation_s,
                probation_max_s=cfg.breaker_probation_max_s,
                probation_factor=cfg.breaker_probation_factor,
                clock=cfg.clock,
                on_transition=self._on_breaker_transition,
            )

        self.compile_governor = (
            CompileGovernor(cfg.compile_rate_per_s, cfg.compile_burst, _breaker("compile"))
            if cfg.compile_breaker
            else None
        )
        self.ckpt_breaker = _breaker("ckpt") if cfg.ckpt_breaker else None
        self.comm_breaker = _breaker("comm") if cfg.comm_breaker else None
        # default quantum: 8 bucket-maxima of rows per dispatch cycle — deep
        # enough that healthy traffic drains in one fast-path cycle (per-cycle
        # fixed costs stay off the <5% overhead gate), shallow enough that a
        # flood's current cycle bounds everyone else's wait; latency-sensitive
        # deployments tune it down (chip_smoke.py Phase N2 serves one)
        self.drain_quantum = (
            cfg.drain_quantum_rows if cfg.drain_quantum_rows is not None else 8 * int(max_rows)
        )
        # the persistent fair backlog: drained requests live HERE (per-tenant
        # deques, weighted-DRR selection), not in the engine's arrival-order
        # queue — selection is O(selected + tenants) per drain regardless of
        # how deep a flooding tenant's backlog grows
        self.backlog = (
            FairBacklog(cfg.tenant_weights, self.drain_quantum)
            if cfg.fair
            else FifoBacklog(self.drain_quantum)
        )
        # submit stamps t_enqueue only when sojourn-time shedding will read it
        self.stamp_enqueue = self.shedder is not None
        # hot-path elision flags (read inline by the engine so a guarded submit
        # with nothing to check costs attribute loads, not calls): full
        # admission runs only when quotas are configured, a deadline was
        # passed, or some tenant has a live failure ledger entry
        self.admission_active = self.quotas.enabled
        self._quarantine_entries = self.quarantine._entries  # same dict object

    # ------------------------------------------------------------------ accounting

    def _count(self, name: str, obs_kind: Optional[str] = None, n: int = 1) -> None:
        self._telemetry.count(name, n)
        if obs_kind is not None:
            _obs.record_guard_event(self._engine_label, obs_kind, n)

    def _on_breaker_transition(self, name: str, old: str, new: str) -> None:
        _obs.set_guard_breaker_state(self._engine_label, name, BREAKER_STATE_CODES[new])

    # ------------------------------------------------------------------ admission

    def admit(self, key: Hashable, rows: int, deadline: Optional[float]) -> Tuple[Optional[float], bool]:
        """Admission checks for one submit; returns ``(abs_deadline, is_probe)``.

        Raises :class:`TenantQuarantined` / :class:`QuotaExceeded` /
        :class:`DeadlineExceeded` (an already-expired deadline never enters the
        queue). A rejected submit consumes no quota tokens.
        """
        verdict = self.quarantine.check(key)
        if verdict == DENY:
            self._count("quarantine_rejections")
            raise TenantQuarantined(
                f"tenant {key!r} is quarantined after repeated request failures; "
                "it fails fast until its probation expires"
            )
        is_probe = verdict == PROBE
        try:
            if deadline is not None and deadline <= 0:
                self._count("deadline_expired", "deadline_expired")
                raise DeadlineExceeded(f"deadline {deadline}s already expired at submit")
            if self.quotas.enabled and not self.quotas.admit(key, rows):
                self._count("quota_rejections", "quota_rejections")
                raise QuotaExceeded(
                    f"tenant {key!r} exceeded its admission quota ({rows} rows refused)"
                )
        except Exception:
            if is_probe:
                self.quarantine.abandon(key)
            raise
        abs_deadline = None if deadline is None else self.clock() + float(deadline)
        return abs_deadline, is_probe

    def abandon_probe(self, key: Hashable) -> None:
        self.quarantine.abandon(key)

    # ------------------------------------------------------------------ drain forming

    def form_drain(
        self, new_requests: List[Any], now: Optional[float] = None
    ) -> Tuple[List[Any], List[Tuple[Any, Exception]]]:
        """Ingest newly drained requests, then form one dispatch batch.

        Returns ``(batch, rejected)``: ``batch`` to dispatch now (fair
        interleave, ≤ drain quantum rows), ``rejected`` as ``(request,
        exception)`` pairs to fail fast (expired deadlines, shed overload
        victims). The un-selected remainder stays in :attr:`backlog` — the
        engine never sees or rescans it, so the per-drain cost is bounded by
        the quantum, not the flood.
        """
        backlog = self.backlog
        shedder = self.shedder
        to_shed: Optional[int] = None  # None = sojourn not yet observed this drain
        # no-backlog fast path: with nothing standing, arrivals that fit the
        # quantum (and carry no deadline) dispatch as-is — no per-tenant queue
        # churn. This is the common healthy regime and what keeps the guard's
        # well-behaved overhead (<5% gate) down in the many-small-drains case.
        if not backlog.count and new_requests:
            total = 0
            any_deadline = False
            for req in new_requests:
                total += int(req.rows)
                if req.deadline is not None:
                    any_deadline = True
            if total <= self.drain_quantum and not any_deadline:
                if shedder is None:
                    return list(new_requests), []
                now = self.clock() if now is None else now
                to_shed = shedder.on_drain(now - new_requests[-1].t_enqueue, now=now)
                if not to_shed:
                    return list(new_requests), []

        backlog.ingest(new_requests)
        rejected: List[Tuple[Any, Exception]] = []

        if shedder is not None and backlog.count:
            now = self.clock() if now is None else now
            newest = backlog.newest_enqueue()
            min_sojourn = 0.0 if newest is None else now - newest
            if to_shed is None:
                to_shed = shedder.on_drain(min_sojourn, now=now)
            if to_shed:
                victims = backlog.shed_oldest(self.cfg.shed_max_priority, to_shed)
                if victims:
                    self._count("shed", "shed", len(victims))
                    for req in victims:
                        self._release_if_probe(req)
                        rejected.append(
                            (req, RequestShed(
                                f"shed under overload (queue sojourn {min_sojourn:.3f}s "
                                f"above target {self.shedder.target_s}s)"
                            ))
                        )

        # deadlines expire lazily, as requests reach selection: an expired
        # request never occupies a batch slot, and the clock is only read if
        # some request actually carries a deadline
        deadline_now = now

        def _expired(req: Any) -> bool:
            nonlocal deadline_now
            if req.deadline is None:
                return False
            if deadline_now is None:
                deadline_now = self.clock()
            return deadline_now >= req.deadline

        batch, expired = backlog.select(reject=_expired)
        if expired:
            self._count("deadline_expired", "deadline_expired", len(expired))
            for req in expired:
                self._release_if_probe(req)
                rejected.append(
                    (req, DeadlineExceeded(f"deadline expired in queue for tenant {req.key!r}"))
                )
        return batch, rejected

    def _release_if_probe(self, req: Any) -> None:
        """A quarantine probe rejected in-queue (shed, expired, failed fast by a
        takeover) never ran — free its probe slot or the tenant is wedged in
        DENY forever (the probation already lapsed, so only the probe flag
        stands between it and re-admission)."""
        if getattr(req, "is_probe", False):
            self.quarantine.abandon(req.key)

    def take_backlog(self) -> List[Any]:
        """Hand every backlogged request to a death/hang takeover replay."""
        return self.backlog.take_all()

    # ------------------------------------------------------------------ outcomes & breakers

    def on_request_outcome(self, key: Hashable, ok: bool) -> None:
        if self.quarantine.record(key, ok):
            self._count("quarantines", "quarantines")

    def allow_compile(self) -> bool:
        if self.compile_governor is None:
            return True
        if self.compile_governor.allow_compile():
            return True
        self._count("compile_rejections")
        return False

    def breaker_snapshots(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        if self.compile_governor is not None:
            out["compile"] = self.compile_governor.breaker.snapshot()
        if self.ckpt_breaker is not None:
            out["ckpt"] = self.ckpt_breaker.snapshot()
        if self.comm_breaker is not None:
            out["comm"] = self.comm_breaker.snapshot()
        return out

    def breakers_open(self) -> List[str]:
        return [name for name, snap in self.breaker_snapshots().items() if snap["state"] != "closed"]

    @property
    def shedding(self) -> bool:
        return self.shedder is not None and self.shedder.dropping

    def publish_health(self, state: str) -> None:
        _obs.set_guard_health(self._engine_label, state)
