"""Shipper — the primary's background publisher of (snapshot, WAL tail)
(port of ``metrics_tpu/repl/shipper.py``).

Runs entirely OFF the write path: one daemon thread that reads the durable
state plane's artifacts from disk (committed snapshot generations, journal
segments via :meth:`~metrics_tpu_torch.ckpt.store.RequestJournal.read_from`) and
publishes them over the configured :class:`~metrics_tpu_torch.repl.transport.ReplTransport`.
The dispatcher never waits on it and it takes no engine lock: its cost to the
primary is what ``chip_smoke.py`` Phase P1 measures against the JAX
benchmark's 5% limit.

Each tick:

1. consume a follower snapshot request / detect a new committed generation →
   publish the newest VALID snapshot (corrupt generations skipped, same
   newest-first policy as recovery) as one :class:`SnapshotFrame`; with no
   snapshot on disk and a journal that starts at seq 0, an *empty bootstrap*
   frame (``data=None``) lets the follower start from fresh init state;
2. tail-follow the WAL from the last shipped seq and publish each record as a
   :class:`WalFrame`. A seq discontinuity (rotation GC'd segments past a laggy
   shipper) flips back to step 1 — the follower re-bootstraps instead of
   silently skipping records;
3. heartbeat (primary position + wall clock) when due, so a caught-up follower
   can bound ``seconds_behind`` on an idle stream.

Transient transport failures are absorbed and retried next tick (``last_error``
remembers, telemetry counts). :class:`~metrics_tpu_torch.repl.errors.FencedError` is
terminal: the link was fenced by a promotion, this process is a deposed
primary, and the ship loop parks permanently (``fenced`` stays True).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

from metrics_tpu_torch.ckpt import format as ckpt_format
from metrics_tpu_torch.obs import instrument as _obs
from metrics_tpu_torch.obs.fleet import node_snapshot
from metrics_tpu_torch.obs.registry import OBS as _OBS
from metrics_tpu_torch.repl.config import ReplConfig
from metrics_tpu_torch.repl.errors import FencedError
from metrics_tpu_torch.repl.transport import HeartbeatFrame, SnapshotFrame, WalFrame

__all__ = ["Shipper"]

_WAL_BATCH = 256  # WalFrames per send — bounds per-send pickling/copy cost


class Shipper:
    """One primary's publish loop over a snapshot store + request journal."""

    def __init__(
        self,
        cfg: ReplConfig,
        *,
        store: Any,
        journal: Any,
        telemetry: Any,
        engine_label: str = "0",
        epoch: Optional[int] = None,
    ) -> None:
        self.cfg = cfg
        self.transport = cfg.transport
        # the engine passes the lineage-recovered token (snapshot meta) when it
        # exceeds the config's — a restarted promoted primary keeps its epoch
        self.epoch = int(cfg.epoch if epoch is None else epoch)
        self._store = store
        self._journal = journal
        self._telemetry = telemetry
        self._engine_label = engine_label

        self.last_shipped_seq = -1
        self.shipped_generation: Optional[int] = None
        # newest generation last ATTEMPTED (shipped or skipped-as-corrupt): a
        # corrupt newest must not trigger a full re-scan + re-ship every tick
        self._seen_generation: Optional[int] = None
        self.fenced = False
        self.journal_lost = False
        self.ship_failures = 0  # transient tick failures (health() surfaces this)
        self.last_error: Optional[BaseException] = None
        self._need_snapshot = True  # first attach always bootstraps the follower
        self._final = False  # close()'s last publish: lets the tail loop run past _stop
        # (newest generation, journal start) the bootstrap parked on: the best
        # valid snapshot + retained WAL couldn't form a chain — don't re-read/
        # re-verify/re-ship until either side of the pair changes
        self._hole_park: Optional[Any] = None
        self._cursor: Optional[Any] = None  # incremental journal tail position
        self._last_heartbeat = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="metrics-tpu-repl-ship", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------------ lifecycle

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=timeout)
        if self.fenced or self.journal_lost or self._thread.is_alive():
            # fenced/journal-lost loops are parked deliberately; a thread that
            # outlived its join may still be mid-tick — no concurrent publish
            return
        try:
            # one FINAL publish: the engine commits its close-time checkpoint
            # before closing the shipper, so everything acked since the last
            # periodic tick — up to a full ship interval's worth of records,
            # plus the final snapshot's generation — is still unpublished
            # here. Exiting without it hands a promoted follower a state
            # missing acknowledged writes after a perfectly graceful shutdown.
            self._final = True
            self.tick()
        except Exception as exc:  # noqa: BLE001 — closing: record, never raise
            self.last_error = exc

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.ship_interval_s):
            try:
                self.tick()
                # full clean pass: a previously-recorded transient is healed
                # (health() stops reporting the link DEGRADED); a persistent
                # failure re-raises every tick and stays visible
                self.last_error = None
            except FencedError as exc:
                # deposed: a newer primary fenced the link. Shipping can never
                # succeed again — park instead of spinning on rejections.
                self.last_error = exc
                self.fenced = True
                self._telemetry.count("fenced_rejections")
                return
            except Exception as exc:  # noqa: BLE001 — transient: retry next tick
                self.last_error = exc
                self.ship_failures += 1
                self._telemetry.count("ship_failures")

    # ------------------------------------------------------------------ ship loop

    def tick(self) -> None:
        """One publish pass (public so tests can drive the loop synchronously)."""
        if self.journal_lost:
            # the engine disabled its WAL after an IO failure: new writes no
            # longer reach the journal, so anything published from here on —
            # above all heartbeats stamping the frozen last_seq — would tell
            # the follower it is CURRENT while the primary diverges unbounded.
            # Going silent is the conservative contract: the follower's
            # seconds_behind grows and bounded reads start refusing.
            return
        t_wall = time.time()
        if self.transport.take_snapshot_request():
            self._need_snapshot = True
        newest = self._newest_generation()
        # routine new-generation ships exist to heal links with NO backchannel
        # (a gapped socket follower can't ask for a bootstrap — the periodic
        # snapshot, with the tail rewound under it, is its only way back).
        # On a backchannel link the follower REQUESTS when it needs one, so a
        # routine ship is a full-state transfer the caught-up follower just
        # drops — pure churn, skipped.
        if self._need_snapshot or (
            newest is not None
            and newest != self._seen_generation
            and not self.transport.has_backchannel
        ):
            self._ship_snapshot(newest, t_wall)
        self._ship_tail(t_wall)
        # pacing on the monotonic clock: a backwards NTP step on wall time must
        # not silence heartbeats (the frame itself still carries t_wall — it
        # only ORDERS advancements on the follower, never ages them)
        now_mono = time.monotonic()
        if now_mono - self._last_heartbeat >= self.cfg.heartbeat_interval_s:
            # piggyback the primary's telemetry snapshot on the heartbeat it
            # already sends — the follower's aggregator merges it into the
            # fleet view with zero new transport surface
            fleet = None
            if _OBS.enabled:
                try:
                    fleet = node_snapshot(f"primary:{self._engine_label}")
                except Exception:  # noqa: BLE001 — telemetry must not break shipping
                    fleet = None
            self.transport.send(
                [HeartbeatFrame(self.epoch, int(self._journal.last_seq), t_wall, fleet)]
            )
            self._last_heartbeat = now_mono

    def _newest_generation(self) -> Optional[int]:
        gens = self._store.generations()
        return gens[-1] if gens else None

    def _ship_snapshot(self, newest: Optional[int], t_wall: float) -> None:
        """Publish the newest snapshot that validates clean (newest-first scan,
        corrupt generations skipped — the recovery policy, applied to shipping)."""
        # a (re)bootstrapping follower — fresh attach, backchannel request, or a
        # tail discontinuity — resumes WAL replay at the SNAPSHOT's position,
        # so the tail must rewind there with it: keeping the old tail position
        # would strand records (snapshot seq, last_shipped] unshipped, and under
        # live traffic the replacement follower re-gaps on every bootstrap,
        # forever (a still-current follower just drops the rewound duplicates).
        # Routine new-generation ships (bootstrap False) keep the tail put.
        bootstrap = self._need_snapshot
        segs = self._journal._segments()
        start = segs[0][0] if segs else None
        if self._hole_park is not None and self._hole_park == (newest, start):
            return  # still unserviceable (see below): wait for a new generation
        for gen in reversed(self._store.generations()):
            try:
                data = self._store.read(gen)
                # full CRC validation before shipping — but no leaf decode: the
                # frame carries the raw bytes, and the seq rides in the manifest
                # meta, so rebuilding the whole tree here would be pure waste
                manifest = ckpt_format.verify(data)
                seq = int(manifest.get("meta", {}).get("seq", -1))
            except Exception:  # noqa: BLE001 — torn/corrupt: fall back one generation
                continue
            if seq < int(self._journal.last_seq) and (start is None or start > seq + 1):
                # history hole: the newest generation is corrupt AND rotation
                # already GC'd the records between this (older) snapshot and
                # the retained journal — no chain can be anchored here. A
                # follower restoring it would gap on the very next record, we
                # would re-ship the full state every tick, and it would never
                # pass the hole (livelock). Park until a new generation
                # commits (or history changes); staleness on the follower
                # grows and bounded reads refuse — the conservative contract.
                self._hole_park = (newest, start)
                self._seen_generation = newest
                self._telemetry.count("ship_history_holes")
                return
            self.transport.send(
                [SnapshotFrame(self.epoch, gen, seq, data, t_wall, bootstrap=bootstrap)]
            )
            # seen only once the send LANDS (or every generation proved
            # corrupt, below): marking before the send would let a transient
            # transport failure eat a routine new-generation ship for good —
            # on a backchannel-less link that ship is the only thing that can
            # un-park a gapped follower before the NEXT checkpoint interval
            self._seen_generation = newest
            self._hole_park = None
            self.shipped_generation = gen
            if bootstrap or seq < self.last_shipped_seq:
                # anchor the tail AT the snapshot — rewind, never advance. A
                # bootstrapping follower resumes WAL replay at the snapshot's
                # position, so records above it must re-ship (a still-current
                # follower just drops the duplicates). The rewind also holds
                # for ROUTINE ships on backchannel-less links: a follower
                # gapped by an in-flight TCP loss restores this snapshot, and
                # without the rewind the records between the snapshot and the
                # live tip would never arrive — it would re-gap on the next
                # frame and loop restore→gap forever. The rewound span is only
                # what landed since the generation committed (one ship
                # interval), so the duplicate churn is a tick's worth of
                # records per checkpoint. ADVANCING the tail is still illegal:
                # a bootstrapped, gap-free follower drops routine snapshots
                # (WAL continuity is its contract), so skipping to the
                # snapshot's seq would strand (last_shipped, seq] unshipped
                # and park it forever — rotation's discontinuity path below is
                # the only legal skip.
                self.last_shipped_seq = seq
                self._cursor = None
            self._need_snapshot = False
            self._telemetry.count("shipped_snapshots")
            return
        # every generation proved corrupt: remember we looked so a rotting
        # newest doesn't trigger a full re-scan every tick (a NEW generation
        # still re-triggers, and _need_snapshot keeps its own retry loop)
        self._seen_generation = newest
        # no valid snapshot on disk: an empty bootstrap is only complete if the
        # journal's history starts at seq 0 (nothing was ever rotated away)
        if not segs or segs[0][0] == 0:
            self.transport.send(
                [SnapshotFrame(self.epoch, -1, -1, None, t_wall, bootstrap=bootstrap)]
            )
            self.shipped_generation = None
            if bootstrap or self.last_shipped_seq > -1:
                # same anchor rule as above: a follower restoring this empty
                # bootstrap resumes at -1, so the whole journal must re-ship
                self.last_shipped_seq = -1
                self._cursor = None
            self._need_snapshot = False
            self._telemetry.count("shipped_snapshots")
        # else: keep _need_snapshot set; the next committed generation ships

    def _ship_tail(self, t_wall: float) -> None:
        if self._need_snapshot:
            return  # nothing to anchor the tail to yet
        # incremental cursor: each tick reads only NEW journal bytes. A send
        # failure leaves last_shipped_seq at the last DELIVERED record — the
        # cursor is then ahead of it, so rebuild it at the delivered position
        # and retransmit (the follower's seq chain drops any duplicates).
        if self._cursor is None or self._cursor.seq != self.last_shipped_seq:
            self._cursor = self._journal.tail_cursor(self.last_shipped_seq)
        shipped = 0
        while self._final or not self._stop.is_set():
            # stop-aware: a deep catch-up (a follower re-attaching behind a
            # 100k-record backlog) must yield to close() between batches, not
            # outlive its join timeout publishing into a torn-down transport
            records = self._cursor.read(max_records=_WAL_BATCH)
            if not records:
                if self._journal.last_seq > self.last_shipped_seq:
                    # the cursor is dry but the journal is ahead: if rotation
                    # GC'd the unshipped span (snapshot-covered) there is no
                    # WAL frame left to trip the gap check below — on a
                    # backchannel link the follower never gaps, never asks,
                    # and the span is silently lost. Re-anchor via snapshot.
                    # (A span still buffered in an unflushed segment keeps its
                    # start at last_shipped+1 and does NOT trigger this.)
                    segs = self._journal._segments()
                    start = segs[0][0] if segs else self._journal.last_seq + 1
                    if start > self.last_shipped_seq + 1:
                        self._need_snapshot = True
                        self._cursor = None
                break
            if records[0][0] != self.last_shipped_seq + 1:
                # rotation GC'd past us while we lagged: records between
                # last_shipped and here are snapshot-covered — re-bootstrap
                self._need_snapshot = True
                self._cursor = None
                break
            self.transport.send(
                [WalFrame(self.epoch, seq, payload, t_wall) for seq, payload in records]
            )
            # delivered: only now does the cursor's progress become durable
            self.last_shipped_seq = records[-1][0]
            shipped += len(records)
        if shipped:
            self._telemetry.count("shipped_records", shipped)
            _obs.record_repl_shipped(self._engine_label, shipped)

    # ------------------------------------------------------------------ raising

    def mark_journal_lost(self) -> None:
        """Engine callback: the WAL was disabled after an IO failure. Park the
        publish loop (see :meth:`tick`) so the follower's staleness grows
        instead of being refreshed against a frozen journal position."""
        if not self.journal_lost:
            self.journal_lost = True
            self._telemetry.count("ship_journal_lost")
