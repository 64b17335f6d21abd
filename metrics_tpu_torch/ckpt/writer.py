"""Background async checkpointer: bounded-staleness snapshots off the hot path
(port of ``metrics_tpu/ckpt/writer.py``).

The owner (the engine dispatcher between micro-batches, or any host loop)
calls :meth:`AsyncCheckpointer.maybe_checkpoint` with a *snapshot function* —
a callable producing a consistent host-side ``(tree, meta)`` view of the state
it wants persisted. The checkpointer decides whether a snapshot is due
(``interval_s`` elapsed) and whether the background writer can take it (one
in-flight write at a time); if so it runs the snapshot function *on the
caller's thread* (that is what makes the view consistent — the owner picks the
quiescent point) and hands the host tree to the writer thread, which
serializes (:mod:`metrics_tpu_torch.ckpt.format`), commits
(:class:`~metrics_tpu_torch.ckpt.store.SnapshotStore`), and records obs series
(bytes, latency, generation, failures) under the configured ``site``. The
view holds numpy leaves: the writer thread never reads a device tensor, which
a later micro-batch may be overwriting.

Staleness is bounded by ``interval_s`` + one serialize/commit, and an overdue
snapshot whose predecessor is still writing is *skipped*, not queued — the
store never falls progressively behind a fast producer. A failed write is
counted and remembered (:attr:`last_error`), never raised into the owner's
loop: checkpointing degrades, serving does not.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from metrics_tpu_torch.ckpt import format as ckpt_format
from metrics_tpu_torch.ckpt.store import SnapshotStore
from metrics_tpu_torch.comm.codec import CodecPolicy
from metrics_tpu_torch.obs import instrument as _obs

__all__ = ["AsyncCheckpointer"]

SnapshotFn = Callable[[], Tuple[Any, Optional[Dict[str, Any]]]]
CommitHook = Callable[[int, Any, Optional[Dict[str, Any]]], None]


class AsyncCheckpointer:
    """One background writer thread over a :class:`SnapshotStore`."""

    def __init__(
        self,
        store: SnapshotStore,
        *,
        interval_s: float = 30.0,
        site: str = "ckpt",
        policy: Optional[CodecPolicy] = None,
        reductions: Optional[Dict[str, Any]] = None,
        schema_version: int = 1,
        on_commit: Optional[CommitHook] = None,
        on_error: Optional[Callable[[BaseException], None]] = None,
    ) -> None:
        self.store = store
        self.interval_s = float(interval_s)
        self.site = site
        self.policy = policy
        self.reductions = reductions
        self.schema_version = int(schema_version)
        self.on_commit = on_commit
        self.on_error = on_error

        self.writes = 0
        self.skipped = 0  # due snapshots dropped because the writer was busy
        self.failures = 0
        # failure streak since the last successful commit — what a circuit
        # breaker (the guard plane) or an operator dashboard keys off
        self.consecutive_failures = 0
        self.last_generation: Optional[int] = None
        self.last_error: Optional[BaseException] = None

        self._last_attempt = time.monotonic()
        self._queue: "queue.Queue[Optional[Tuple[Any, Optional[Dict[str, Any]]]]]" = queue.Queue(
            maxsize=1
        )
        self._idle = threading.Event()
        self._idle.set()
        # serializes claiming the idle slot: maybe_checkpoint (any producer
        # thread) and checkpoint_sync (caller thread) must never both decide
        # the writer is free and commit concurrently
        self._claim_lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name=f"metrics-tpu-torch-ckpt-{site}", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------------ producer side

    def due(self) -> bool:
        return time.monotonic() - self._last_attempt >= self.interval_s

    def maybe_checkpoint(self, snapshot_fn: SnapshotFn, *, force: bool = False) -> bool:
        """Take + enqueue a snapshot if one is due and the writer is free.

        Returns True when a snapshot was handed to the writer. Never raises
        from the write path; never blocks beyond the snapshot function itself.
        """
        if self._closed:
            return False
        if not force and not self.due():
            return False
        while True:
            with self._claim_lock:
                if self._idle.is_set():
                    self._idle.clear()  # claimed
                    break
            if not force:
                # busy: SKIP, and do NOT reset the timer — the next call
                # retries as soon as the writer frees up, keeping worst-case
                # staleness at interval_s + one write, not 2x interval_s
                self.skipped += 1
                return False
            # a forced snapshot waits for the in-flight write instead of
            # silently racing it for the claim
            self._idle.wait()
        self._last_attempt = time.monotonic()
        try:
            tree, meta = snapshot_fn()
        except BaseException:
            self._idle.set()  # never strand the claim on a snapshot failure
            raise
        self._queue.put((tree, meta))
        return True

    def checkpoint_sync(self, snapshot_fn: SnapshotFn) -> Optional[int]:
        """Snapshot + write on the calling thread (quiesce points, close paths).

        Claims the writer's idle slot first, so a concurrent background write
        can never commit alongside it (two commits racing ``next_generation``
        could pick the same number). Returns the committed generation, or
        ``None`` on failure (recorded, not raised — same contract as the
        async path).
        """
        while True:
            self._idle.wait()
            with self._claim_lock:
                if self._idle.is_set():
                    self._idle.clear()
                    break
        try:
            self._last_attempt = time.monotonic()
            tree, meta = snapshot_fn()
            return self._write(tree, meta)
        finally:
            self._idle.set()

    def quiesce(self, timeout: Optional[float] = None) -> bool:
        """Block until no write is in flight. True if idle was reached."""
        return self._idle.wait(timeout)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._queue.put(None)
        self._thread.join(timeout=30.0)

    # ------------------------------------------------------------------ writer side

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                self._idle.set()
                return
            tree, meta = item
            try:
                self._write(tree, meta)
            finally:
                self._idle.set()

    def _write(self, tree: Any, meta: Optional[Dict[str, Any]]) -> Optional[int]:
        t0 = time.perf_counter()
        try:
            with _obs.ckpt_span("ckpt.write", site=self.site):
                data = ckpt_format.dumps(
                    tree,
                    policy=self.policy,
                    reductions=self.reductions,
                    schema_version=self.schema_version,
                    meta=meta,
                )
                gen = self.store.commit(data)
        except BaseException as exc:  # noqa: BLE001 — a failed write must not kill the owner
            self.failures += 1
            self.consecutive_failures += 1
            self.last_error = exc
            _obs.record_ckpt_failure(self.site, "write")
            if self.on_error is not None:
                try:
                    self.on_error(exc)
                except Exception:  # noqa: BLE001 — best-effort callback
                    pass
            return None
        self.writes += 1
        self.consecutive_failures = 0
        self.last_generation = gen
        _obs.record_ckpt_io(self.site, "write", len(data), time.perf_counter() - t0, generation=gen)
        if self.on_commit is not None:
            try:
                self.on_commit(gen, tree, meta)
            except Exception as exc:  # noqa: BLE001 — best-effort callback
                self.last_error = exc
        return gen
