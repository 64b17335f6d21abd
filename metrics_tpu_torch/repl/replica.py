"""ReplicaApplier — the follower's receive/replay loop + staleness accounting
(port of ``metrics_tpu/repl/replica.py``).

One daemon thread per follower engine: receive frames from the transport,
bootstrap from the first applicable :class:`SnapshotFrame` through the engine's
existing restore path, then replay :class:`WalFrame` records *in seq order*
through the engine's recovery machinery (chunk records replay through the
follower's own bucket graphs; request records re-apply whole) — so the follower's accumulator
state is **bit-identical to the primary at every applied seq**. Out-of-order
protection is the seq chain itself: a duplicate (seq <= applied) is dropped, a
gap (seq > applied+1) parks replay and requests a fresh snapshot instead of
ever applying a record twice or out of order.

Staleness: the applier tracks ``known_seq`` (the primary's newest position it
has heard of, via WAL frames and heartbeats) and the LOCAL monotonic instant
it last learned it was current (frame wall stamps only order advancements —
never compared against this host's clock, so cross-host skew cannot shrink
the reported staleness). :meth:`lag` derives
:class:`~metrics_tpu_torch.repl.config.ReplicaLag` from the two — conservative by
construction: a silent link GROWS ``seconds_behind`` rather than freezing it,
and the only optimism left is one link transit time.

Promotion support: :meth:`stop` halts the thread; :meth:`drain` applies
everything already shipped (the promoted follower serves exactly the acked
prefix); the engine then fences the transport at ``epoch + 1``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Optional

from metrics_tpu_torch.obs import instrument as _obs
from metrics_tpu_torch.obs.fleet import AGGREGATOR
from metrics_tpu_torch.repl.config import ReplConfig, ReplicaLag
from metrics_tpu_torch.repl.transport import HeartbeatFrame, ShipFrame, SnapshotFrame, WalFrame

__all__ = ["ReplicaApplier"]


class ReplicaApplier:
    """One follower's receive loop over a :class:`ReplTransport`."""

    def __init__(self, engine: Any, cfg: ReplConfig, *, telemetry: Any, engine_label: str = "0") -> None:
        self.cfg = cfg
        self.transport = cfg.transport
        self.epoch = int(cfg.epoch)  # newest primary epoch heard (fencing floor)
        self._engine = engine
        self._telemetry = telemetry
        self._engine_label = engine_label

        self.applied_seq = -1
        self.known_seq = -1
        # the lineage known_seq was learned from: positions are only comparable
        # within one epoch, so hearing a HIGHER-epoch frame resets known_seq to
        # that lineage's numbering, while frames of the tracked epoch just max
        self._known_epoch = int(cfg.epoch)
        self.bootstrapped = False
        self.caught_up_wall: Optional[float] = None  # newest primary stamp seen (ordering only)
        # LOCAL monotonic instant of the advancement: seconds_behind is the age
        # since this replica last learned it was current — never a difference
        # of two hosts' wall clocks, which skew could silently shrink below the
        # true staleness (the opposite of a conservative bound)
        self._caught_up_mono: Optional[float] = None
        self.last_error: Optional[BaseException] = None
        self.parked = False  # terminal: promotion flipped the engine writable
        self._gap = False
        self._last_snap_request = 0.0
        # serializes frame application between the poll thread and a promotion
        # drain (which stops the thread first, but belt-and-suspenders)
        self._apply_lock = threading.Lock()
        self._progress = threading.Condition()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="metrics-tpu-repl-apply", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------------ lifecycle

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=timeout)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                frames = self.transport.recv(timeout_s=self.cfg.poll_interval_s)
                if frames:
                    self.apply_frames(frames)
                if self._gap or not self.bootstrapped:
                    # gapped — or never bootstrapped at all: a REPLACEMENT
                    # follower attaching after the shipper's attach-time
                    # snapshot was consumed (by a dead predecessor) would
                    # otherwise wait passively for the next checkpoint
                    # generation, discarding WAL frames the whole time
                    self._maybe_request_snapshot()
            except Exception as exc:  # noqa: BLE001 — a bad frame/transport blip must not kill replay
                self.last_error = exc

    def _maybe_request_snapshot(self) -> None:
        now = time.monotonic()
        if now - self._last_snap_request >= max(self.cfg.poll_interval_s, 0.05):
            self._last_snap_request = now
            self.transport.request_snapshot()

    # ------------------------------------------------------------------ replay

    def apply_frames(self, frames: List[ShipFrame]) -> None:
        applied = 0
        batch_clean = True
        with self._apply_lock:
            if self.parked:
                # promotion already flipped the engine writable: a straggling
                # poll-thread batch (stop()'s join can time out mid-compile)
                # must not replay old-primary records into the new lineage —
                # they would mutate promoted state unjournaled
                return
            for frame in frames:
                if frame.epoch < self.epoch:
                    # transport-level fencing is authoritative, but a follower
                    # that heard a newer epoch drops stragglers here too
                    self._telemetry.count("fenced_rejections")
                    continue
                if frame.epoch > self.epoch:
                    # a higher epoch is a NEW primary lineage (a replacement
                    # primary bumps ReplConfig.epoch; every resumed primary
                    # bumps too): its seq numbering is fresh, so park replay
                    # until that lineage's snapshot arrives rather than
                    # mistaking its records for duplicates
                    self.epoch = frame.epoch
                    if self.bootstrapped:
                        self._gap = True
                try:
                    if isinstance(frame, WalFrame):
                        applied += self._apply_wal(frame)
                    elif isinstance(frame, SnapshotFrame):
                        self._apply_snapshot(frame)
                    elif isinstance(frame, HeartbeatFrame):
                        fleet = getattr(frame, "fleet", None)  # old pickles lack the slot
                        if fleet is not None:
                            AGGREGATOR.ingest(fleet)
                        self._learn_known(frame.epoch, frame.last_seq)
                        if (
                            self.bootstrapped
                            and not self._gap
                            # gapped: applied and last_seq may be positions in
                            # two DIFFERENT lineages — old applied 10000 vs a
                            # replacement's last_seq 40 would stamp the broken
                            # replica fresh; freshness only moves on a whole chain
                            and self.applied_seq >= frame.last_seq
                        ):
                            self._advance_caught_up(frame.t_wall)
                except Exception as exc:  # noqa: BLE001 — recv is destructive:
                    # one bad frame (e.g. a snapshot that CRC-verifies on the
                    # shipper but fails decode here) must not discard the rest
                    # of the batch — the WAL frames behind it are gone from the
                    # transport. Count + remember; the seq chain parks on any
                    # resulting gap and the snapshot path re-requests.
                    self.last_error = exc
                    batch_clean = False
                    self._telemetry.count("apply_failures")
            if frames and batch_clean and self.bootstrapped and not self._gap:
                # a NON-EMPTY batch applied cleanly on a WHOLE chain: a
                # previously-recorded error is healed and health() stops
                # reporting DEGRADED. Clearing on a bare recv return would
                # wipe a persistent frame-level failure on the very next IDLE
                # poll; clearing while un-bootstrapped/gapped would let the
                # 1s heartbeats mask a snapshot that fails decode every 30s
                # checkpoint interval — a replica permanently unable to
                # bootstrap would read SERVING ~97% of the time. While the
                # chain is broken, only the snapshot that mends it (setting
                # bootstrapped, clearing the gap, in this same batch) lets a
                # clean batch clear the record.
                self.last_error = None
        if applied:
            self._telemetry.count("applied_records", applied)
            _obs.record_repl_applied(self._engine_label, applied)
            # bound the async replay pipeline at one recv batch: replay kernels
            # enqueue without blocking (throughput), but a reader forcing a
            # value must never wait out an unbounded chain of pending chunks
            self._engine._repl_quiesce()
        with self._progress:
            self._progress.notify_all()
        if _obs.OBS.enabled:
            lag = self.lag()
            _obs.set_repl_lag(self._engine_label, lag.seqs_behind, lag.seconds_behind)

    def _learn_known(self, epoch: int, seq: int) -> None:
        """Record a primary position. Positions are only comparable within one
        lineage: a HIGHER-epoch source resets known_seq to that lineage's
        numbering (and drops the old lineage's freshness ordering stamp — a
        dead primary's clock must not gate the new one's advancements), while
        a source at the tracked epoch just advances the max."""
        if epoch > self._known_epoch:
            self._known_epoch = epoch
            self.known_seq = seq
            self.caught_up_wall = None
        elif seq > self.known_seq:
            self.known_seq = seq

    def _adopt_lineage(self) -> None:
        # the snapshot LANDED (restore did not raise): the chain is whole again
        self._gap = False

    def _advance_caught_up(self, t_wall: float) -> None:
        # the frame's primary wall stamp only ORDERS advancements (an old
        # re-delivered frame must not refresh freshness); the age itself is
        # measured on this host's monotonic clock
        if self.caught_up_wall is None or t_wall >= self.caught_up_wall:
            self.caught_up_wall = t_wall
            self._caught_up_mono = time.monotonic()

    def _apply_snapshot(self, frame: SnapshotFrame) -> None:
        if (
            self.bootstrapped
            and not self._gap
            and not (frame.bootstrap and frame.seq > self.applied_seq)
        ):
            # intact seq chain: WAL replay already covers (in order) everything
            # this snapshot holds — even while LAGGING, restoring would throw
            # away state just to rebuild it, and a large state's repeated
            # restore can itself keep the replica behind. Snapshot restores are
            # for (re)bootstrap only: never-bootstrapped, gap-parked, or
            # new-lineage followers (an epoch bump sets _gap before dispatch).
            # The one exception is a BOOTSTRAP-flagged snapshot AHEAD of our
            # applied position: the shipper re-bootstrapped because rotation
            # GC'd records it never shipped, so the chain up to frame.seq will
            # never complete — the snapshot is the only way forward. (A
            # bootstrap ship at/behind our position is a rewind for a dead
            # predecessor: drop it and the rewound WAL duplicates after it.)
            return
        # seq accounting resets ONLY when the snapshot comes from a lineage
        # NEWER than the one known_seq was learned from (see _learn_known) —
        # never on a bare seq/epoch comparison against our applied position: a
        # same-lineage gap healed by a snapshot OLDER than applied (checkpoints
        # lag the WAL tail, so a requested re-bootstrap routinely lands behind
        # us), or a fresh attach whose heartbeats already taught us this
        # lineage's tip, must both KEEP the known position — wiping it would
        # transiently report the replica caught up while the records between
        # snapshot and the primary's real tip are still in flight, and bounded
        # reads would serve exactly the staleness they were configured to
        # refuse.
        if frame.data is None:
            # empty bootstrap: the primary's state at frame.seq IS fresh init —
            # also the only answer a wiped primary with no snapshot yet can
            # give a gapped follower (its WAL starts at 0, so reset + replay
            # reconverges); ignoring it would park the follower forever
            if self.bootstrapped:
                self._engine._repl_reset_state()
            self.bootstrapped = True
            self.applied_seq = frame.seq
            self._learn_known(frame.epoch, frame.seq)
            self._adopt_lineage()
            self._telemetry.count("snapshot_loads")
            return
        self._engine._repl_restore_snapshot(frame.data)
        self.applied_seq = frame.seq
        self._learn_known(frame.epoch, frame.seq)
        self.bootstrapped = True
        self._adopt_lineage()
        if self.applied_seq >= self.known_seq:
            # nothing newer heard: state is current through the ship instant
            self._advance_caught_up(frame.t_wall)
        self._telemetry.count("snapshot_loads")

    def _apply_wal(self, frame: WalFrame) -> int:
        self._learn_known(frame.epoch, frame.seq)
        if not self.bootstrapped or self._gap:
            # waiting for a (re-)bootstrap snapshot. Gapped MUST park too: a
            # replacement primary's restarted seq numbering means seq/applied
            # arithmetic compares positions from two different lineages — a
            # new-lineage record whose seq lands on applied+1 would otherwise
            # replay onto old-lineage state, silently diverging from both.
            return 0
        if frame.seq <= self.applied_seq:
            return 0  # duplicate (re-ship overlap): exactly-once, drop
        if frame.seq != self.applied_seq + 1:
            self._gap = True  # rotation/loss upstream: re-bootstrap, never skip
            return 0
        self._engine._repl_apply_record(frame.payload)
        self.applied_seq = frame.seq
        if self.applied_seq >= self.known_seq:
            # freshness only advances when CAUGHT UP: a replica chewing through
            # a deep backlog is serving old data however recently it applied a
            # record — advancing per record would read seconds_behind≈0 at
            # arbitrary real staleness, the opposite of the conservative bound
            self._advance_caught_up(frame.t_wall)
        return 1

    # ------------------------------------------------------------------ promotion

    def park(self) -> None:
        """Terminal: called by promotion AFTER the drain. From here every
        apply is a no-op — even if the poll thread outlived ``stop()``'s join
        timeout (wedged in a cold kernel compile), it can never replay
        old-primary records into the promoted, writable engine."""
        with self._apply_lock:
            self.parked = True

    def drain(self, timeout_s: float) -> None:
        """Apply everything already shipped: poll the transport until it stays
        empty (or ``timeout_s`` elapses). Called with the poll thread stopped."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        quiet = 0
        while time.monotonic() < deadline:
            frames = self.transport.recv(timeout_s=0.0)
            if frames:
                quiet = 0
                self.apply_frames(frames)
                continue
            quiet += 1
            if quiet >= 2:  # two consecutive empty polls: the tail is drained
                return
            time.sleep(min(0.01, self.cfg.poll_interval_s))

    # ------------------------------------------------------------------ staleness

    def lag(self) -> ReplicaLag:
        seqs = max(0, self.known_seq - self.applied_seq)
        if not self.bootstrapped or self._gap or self._caught_up_mono is None:
            # gapped: the chain is broken — applied and known may even be
            # positions in two different lineages, so no finite bound holds
            return ReplicaLag(seqs_behind=seqs, seconds_behind=float("inf"))
        return ReplicaLag(
            seqs_behind=seqs, seconds_behind=max(0.0, time.monotonic() - self._caught_up_mono)
        )

    def watermark(self) -> "tuple[int, int]":
        """``(epoch, applied_seq)`` — this follower's applied WAL position.

        The pair is the generation-safe watermark the query plane's result
        cache keys on: seq numbers are only comparable within one primary
        lineage, so a failover (new epoch, fresh numbering) can never be
        mistaken for "the seq has not advanced". Taken under the apply lock:
        a torn read across an epoch flip could pair the old lineage's epoch
        with the new lineage's seq numbering and alias a fresh position onto
        a cached one."""
        with self._apply_lock:
            return (int(self.epoch), int(self.applied_seq))

    def await_seq(self, seq: int, timeout_s: float = 10.0) -> bool:
        """Test/ops helper: block until ``applied_seq >= seq`` (True) or timeout."""
        deadline = time.monotonic() + timeout_s
        with self._progress:
            while self.applied_seq < seq:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._progress.wait(remaining)
        return True
