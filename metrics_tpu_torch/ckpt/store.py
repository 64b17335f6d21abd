"""Durable snapshot store + request journal: crash-safe files on a local dir
(port of ``metrics_tpu/ckpt/store.py``: the same layout and file names, so either
package recovers from a directory the other wrote).

**SnapshotStore** — generational snapshots with atomic commit. A commit writes
to a dot-prefixed temp file in the same directory, ``fsync``\\ s it, then
``os.replace``\\ s onto the final name and fsyncs the directory: a reader (or a
restart) either sees the complete previous generation or the complete new one,
never a torn file under the real name. A torn *temp* file left by a crash is
invisible to the generation scan and swept on the next construction.
Retention keeps the newest ``retain`` generations per rank; recovery
(:meth:`latest_valid`) walks generations newest-first and skips anything whose
checksums (or caller-supplied validation) fail — a bit-flipped or truncated
snapshot costs one generation of staleness, never a corrupt restore.

Multihost: each rank owns its own file per generation
(``gen-<g>.rank<r>-of<w>.ckpt``) — persisting never needs a gather, and one
rank's corruption never blocks another's recovery.

**RequestJournal** — a WAL-style append log for the engine's
accepted-after-last-snapshot requests. Records are length+CRC framed; replay
stops at the first torn frame (the crash tail), so a record is either replayed
whole or not at all. Segments rotate at snapshot commits and segments fully
covered by a snapshot are deleted.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from metrics_tpu_torch.ckpt import format as ckpt_format
from metrics_tpu_torch.ckpt.format import MAGIC, CorruptSnapshotError, Snapshot
from metrics_tpu_torch.obs import instrument as _obs
from metrics_tpu_torch.utils.prints import rank_zero_warn

__all__ = ["JournalTailCursor", "RequestJournal", "SnapshotStore", "atomic_write"]

_TMP_PREFIX = ".tmp."


def _fsync_dir(path: str) -> None:
    """Make a rename durable: fsync the containing directory (POSIX). Best
    effort — platforms without dir-fd fsync (or exotic filesystems) skip."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path: str, data: bytes, *, durable: bool = True) -> None:
    """Write ``data`` to ``path`` atomically: temp file + fsync + rename.

    ``durable=False`` skips the fsyncs (tests, throwaway dirs) but keeps the
    atomic rename — readers still never observe a torn file.
    """
    d, name = os.path.split(os.path.abspath(path))
    tmp = os.path.join(d, f"{_TMP_PREFIX}{name}.{os.getpid()}")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        if durable:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if durable:
        _fsync_dir(d)


class SnapshotStore:
    """Generational snapshot files under one directory, atomic per commit."""

    def __init__(
        self,
        root: str,
        *,
        retain: int = 3,
        rank: int = 0,
        world: int = 1,
        durable: bool = True,
    ) -> None:
        if retain < 1:
            raise ValueError(f"retain must be >= 1, got {retain}")
        if not (0 <= rank < world):
            raise ValueError(f"rank must be in [0, world), got rank={rank} world={world}")
        self.root = os.path.abspath(root)
        self.retain = int(retain)
        self.rank = int(rank)
        self.world = int(world)
        self.durable = durable
        # generations skipped by the last latest_valid scan: (generation, reason)
        self.last_skipped: List[Tuple[int, str]] = []
        os.makedirs(self.root, exist_ok=True)
        self._sweep_tmp()

    # ------------------------------------------------------------------ layout

    def _suffix(self) -> str:
        return f".rank{self.rank:05d}-of{self.world:05d}.ckpt"

    def path(self, generation: int) -> str:
        return os.path.join(self.root, f"gen-{generation:012d}{self._suffix()}")

    def generations(self) -> List[int]:
        """This rank's committed generations, ascending."""
        out = []
        suffix = self._suffix()
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        for name in names:
            if name.startswith("gen-") and name.endswith(suffix):
                try:
                    out.append(int(name[len("gen-") : len("gen-") + 12]))
                except ValueError:
                    continue
        return sorted(out)

    def _sweep_tmp(self) -> None:
        # A crash mid-commit leaves only an invisible temp file. Sweep every
        # temp matching THIS store's rank suffix regardless of pid — the dead
        # writer's pid is gone, and each rank has a single owner, so any
        # same-rank temp here is an orphan (other ranks' temps are left alone).
        marker = f"{_TMP_PREFIX}gen-"
        suffix = self._suffix() + "."
        for name in os.listdir(self.root):
            if name.startswith(marker) and suffix in name:
                try:
                    os.remove(os.path.join(self.root, name))
                except OSError:
                    pass

    # ------------------------------------------------------------------ writes

    def next_generation(self) -> int:
        gens = self.generations()
        return (gens[-1] + 1) if gens else 0

    def commit(self, data: bytes, *, generation: Optional[int] = None) -> int:
        """Atomically persist one snapshot blob; returns its generation."""
        gen = self.next_generation() if generation is None else int(generation)
        atomic_write(self.path(gen), data, durable=self.durable)
        self.gc()
        return gen

    def gc(self) -> List[int]:
        """Delete this rank's oldest generations beyond ``retain``; returns them."""
        gens = self.generations()
        dropped = gens[: -self.retain] if len(gens) > self.retain else []
        for g in dropped:
            try:
                os.remove(self.path(g))
            except OSError:
                pass
        return dropped

    def delete(self, generation: int) -> None:
        try:
            os.remove(self.path(generation))
        except FileNotFoundError:
            pass

    # ------------------------------------------------------------------ reads

    def read(self, generation: int) -> bytes:
        with open(self.path(generation), "rb") as f:
            return f.read()

    def read_meta(self, generation: int) -> Dict[str, Any]:
        """One generation's manifest ``meta`` — header + manifest bytes only,
        no payload decode (CRC-checked; corrupt manifests raise)."""
        with open(self.path(generation), "rb") as f:
            head = f.read(len(MAGIC) + 12)
            if len(head) < len(MAGIC) + 12:
                raise CorruptSnapshotError("truncated header")
            (mlen,) = struct.unpack_from("<Q", head, len(MAGIC))
            data = head + f.read(mlen)
        return ckpt_format.read_manifest(data).get("meta", {})

    def latest_valid(
        self, *, validate: Optional[Callable[[Snapshot], None]] = None
    ) -> Optional[Tuple[int, Snapshot]]:
        """Newest generation that decodes, checksums, and validates clean.

        Walks newest-first; a corrupt/torn/unreadable generation (or one the
        caller's ``validate`` rejects) is recorded in :attr:`last_skipped` and
        the scan falls back to the previous one. ``None`` when nothing valid
        exists.
        """
        self.last_skipped = []
        found = None
        for gen in reversed(self.generations()):
            try:
                snap = ckpt_format.loads(self.read(gen))
                if validate is not None:
                    validate(snap)
                found = (gen, snap)
                break
            except (CorruptSnapshotError, OSError, ValueError, KeyError, TypeError) as exc:
                self.last_skipped.append((gen, f"{type(exc).__name__}: {exc}"))
        if self.last_skipped:
            # a silently skipped generation is silent corruption to an operator:
            # each skip costs one generation of recovery staleness, and a full
            # sweep of skips means NOTHING was recoverable — say so, loudly
            # (warn always; counter master-gated like every obs series)
            for gen, reason in self.last_skipped:
                _obs.record_ckpt_skipped(reason.split(":", 1)[0])
            rank_zero_warn(
                f"SnapshotStore({self.root!r}): skipped {len(self.last_skipped)} corrupt/invalid "
                f"generation(s) during recovery scan: "
                + "; ".join(f"gen {g}: {r}" for g, r in self.last_skipped[:3])
                + ("; ..." if len(self.last_skipped) > 3 else "")
                + (" — recovered from an older generation" if found is not None
                   else " — NO valid generation remained"),
                RuntimeWarning,
            )
        return found


# ---------------------------------------------------------------------- journal

_FRAME = struct.Struct("<II")  # payload nbytes, payload crc32


class RequestJournal:
    """Append-only, CRC-framed request log with segment rotation.

    Each record gets a monotone sequence number, persistent across reopen
    (segments are named by their first seq; a record's seq is first_seq +
    index). Appends go through an internal lock; :meth:`append_many` batches
    one ``write`` for a drained engine batch. ``sync`` policy per append is
    the caller's call — :meth:`flush` exposes flush-only and fsync levels.

    ``synced_seq`` is the highest seq known fsynced to stable storage —
    advanced wherever a real fsync lands (durable ``flush(fsync=True)``,
    rotation, close) and initialised to ``last_seq`` on reopen (whatever the
    scan found on disk has, by definition, survived). The engine's
    ``wal_fsync="commit"`` durability contract is exactly "a reopen never
    resumes numbering below ``synced_seq``".
    """

    def __init__(self, root: str, *, name: str = "wal", rank: int = 0, durable: bool = True) -> None:
        self.root = os.path.abspath(root)
        self.name = name
        self.rank = int(rank)
        self.durable = durable
        self.torn_records = 0  # frames dropped at a torn tail during scan/replay
        self.appended_bytes = 0  # framed bytes appended by this instance
        self._lock = threading.Lock()
        self._file: Optional[Any] = None
        os.makedirs(self.root, exist_ok=True)
        self.last_seq = -1
        segs = self._segments()
        if segs:
            # resume numbering after everything already on disk; a torn tail
            # (crash mid-append) is truncated away so records appended after
            # the reopen stay replayable behind an unbroken seq chain
            first, path = segs[-1]
            records, clean_len, torn = self._scan_segment(path)
            if torn:
                with open(path, "r+b") as f:
                    f.truncate(clean_len)
            self.last_seq = first + records - 1
        self.synced_seq = self.last_seq

    # ------------------------------------------------------------------ layout

    def _seg_path(self, first_seq: int) -> str:
        return os.path.join(self.root, f"{self.name}-{first_seq:012d}.rank{self.rank:05d}.log")

    def _segments(self) -> List[Tuple[int, str]]:
        """(first_seq, path) ascending."""
        out = []
        marker = f".rank{self.rank:05d}.log"
        prefix = f"{self.name}-"
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        for n in names:
            if n.startswith(prefix) and n.endswith(marker):
                try:
                    out.append((int(n[len(prefix) : len(prefix) + 12]), os.path.join(self.root, n)))
                except ValueError:
                    continue
        return sorted(out)

    # ------------------------------------------------------------------ writes

    def _ensure_file(self) -> Any:
        if self._file is None:
            self._file = open(self._seg_path(self.last_seq + 1), "ab")
        return self._file

    @staticmethod
    def _frame(payload: bytes) -> bytes:
        return _FRAME.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload

    def append(self, payload: bytes) -> int:
        """Append one record; returns its sequence number."""
        return self.append_many([payload])[-1]

    def append_many(self, payloads: List[bytes]) -> List[int]:
        """Append a batch under one lock/one write; returns the seqs in order."""
        if not payloads:
            return []
        frames = b"".join(self._frame(p) for p in payloads)
        with self._lock:
            f = self._ensure_file()
            f.write(frames)
            self.appended_bytes += len(frames)
            seqs = list(range(self.last_seq + 1, self.last_seq + 1 + len(payloads)))
            self.last_seq = seqs[-1]
        return seqs

    def flush(self, *, fsync: bool = False) -> None:
        with self._lock:
            if self._file is not None:
                self._file.flush()
                if fsync and self.durable:
                    os.fsync(self._file.fileno())
                    self.synced_seq = self.last_seq

    def rotate(self, covered_seq: int) -> None:
        """Start a fresh segment; drop segments fully covered by ``covered_seq``
        (i.e. whose every record a snapshot at that seq already includes)."""
        with self._lock:
            if self._file is not None:
                self._file.flush()
                if self.durable:
                    os.fsync(self._file.fileno())
                    self.synced_seq = self.last_seq
                self._file.close()
                self._file = None
            segs = self._segments()
            for i, (first, path) in enumerate(segs):
                next_first = segs[i + 1][0] if i + 1 < len(segs) else self.last_seq + 1
                if next_first - 1 <= covered_seq:
                    try:
                        os.remove(path)
                    except OSError:
                        pass

    def skip_to(self, seq: int) -> None:
        """Number the next record ``seq + 1`` when the journal ends below ``seq``.

        A snapshot at ``seq`` covers every record up to it, and the rotation after
        its commit deletes every segment it covers, all of them after a final
        snapshot. Reopened then, the journal finds no segment and would number
        from 0, and a replay after ``seq`` would pass over every later record.
        What segments remain below ``seq`` are covered, and are dropped.
        """
        with self._lock:
            if seq <= self.last_seq:
                return
        self.rotate(covered_seq=seq)
        with self._lock:
            self.last_seq = max(self.last_seq, int(seq))
            self.synced_seq = max(self.synced_seq, self.last_seq)

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.flush()
                if self.durable:
                    os.fsync(self._file.fileno())
                    self.synced_seq = self.last_seq
                self._file.close()
                self._file = None

    # ------------------------------------------------------------------ reads

    @staticmethod
    def _scan_segment(path: str) -> Tuple[int, int, bool]:
        """(intact record count, clean byte length, torn?) for one segment."""
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return 0, 0, False
        off = records = 0
        while off + _FRAME.size <= len(data):
            n, crc = _FRAME.unpack_from(data, off)
            payload = data[off + _FRAME.size : off + _FRAME.size + n]
            if len(payload) != n or (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                return records, off, True
            records += 1
            off += _FRAME.size + n
        return records, off, off != len(data)

    def _read_segment(self, path: str) -> Iterator[bytes]:
        """Yield whole records; stop at the first torn/corrupt frame (crash tail)."""
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return
        off = 0
        while off + _FRAME.size <= len(data):
            n, crc = _FRAME.unpack_from(data, off)
            payload = data[off + _FRAME.size : off + _FRAME.size + n]
            if len(payload) != n or (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                self.torn_records += 1
                return
            yield payload
            off += _FRAME.size + n
        if off != len(data):
            self.torn_records += 1

    def read_from(self, after_seq: int = -1) -> Iterator[Tuple[int, bytes]]:
        """Cross-segment tail-follow read: ``(seq, record)`` for every intact
        record with seq > ``after_seq``, in order — safe under a live writer and
        concurrent :meth:`rotate`.

        Unlike :meth:`replay` (the exclusive-reopen recovery path), this NEVER
        truncates: a follower/shipper tailing the primary's journal must not
        destroy the primary's in-flight tail. An incomplete final frame (the
        writer mid-append) simply ends the iteration — call again with the last
        yielded seq to continue once the append lands. Segments wholly covered
        by ``after_seq`` are skipped without reading; a segment deleted by a
        concurrent ``rotate(covered_seq)`` ends the iteration (its records were
        snapshot-covered — the caller sees the seq discontinuity on the next
        call and falls back to a snapshot). Yielded seqs are strictly ascending
        and contiguous within one call.

        One frame-parse implementation serves both tail-follow APIs: this is a
        thin one-pass loop over :class:`JournalTailCursor`, with the
        within-one-call contiguity contract enforced here (the stateful cursor
        instead surfaces a rotation gap as a seq jump across polls).
        """
        cursor = self.tail_cursor(after_seq)
        last: Optional[int] = None
        batch = 1024  # stream in bounded slices — read_from must stay lazy
        while True:
            records = cursor.read(max_records=batch)
            for seq, payload in records:
                if last is not None and seq != last + 1:
                    return  # discontinuity (tear/rotation mid-walk): stop here
                yield seq, payload
                last = seq
            if len(records) < batch:
                return  # reached the tail: one pass, like the segment walk

    def tail_cursor(self, after_seq: int = -1) -> "JournalTailCursor":
        """A stateful incremental reader with :meth:`read_from`'s semantics —
        for pollers (the repl shipper) that tail the journal every few ms and
        must not re-read/re-CRC the whole active segment per poll."""
        return JournalTailCursor(self, after_seq)

    def replay(self, after_seq: int = -1) -> Iterator[Tuple[int, bytes]]:
        """Yield ``(seq, record)`` for every intact record with seq > ``after_seq``.

        A torn frame ends its segment, and everything after the tear is
        unordered relative to it — replay stops there: exactly the records
        whose append completed before the crash, in order.
        """
        self.flush()
        expected = None
        for first, path in self._segments():
            if expected is not None and first != expected:
                return  # seq gap (e.g. manually removed segment): stop
            before = self.torn_records
            seq = first
            for payload in self._read_segment(path):
                if seq > after_seq:
                    yield seq, payload
                seq += 1
            if self.torn_records != before:
                return  # torn tail: nothing after it is trustworthy
            expected = seq


class JournalTailCursor:
    """Stateful tail-follow over a live :class:`RequestJournal`.

    Same contract as :meth:`RequestJournal.read_from` (never truncates; an
    incomplete tail frame ends a poll; a rotation-induced gap surfaces as a
    seq jump), but the position — (segment, byte offset, next seq) — persists
    between polls, so each :meth:`read` costs only the NEW tail bytes. Polling
    ``read_from`` instead re-reads and re-CRCs the entire active segment every
    time: O(segment) per poll, quadratic over a segment's lifetime — exactly
    what a 20ms-tick shipper must not do.
    """

    def __init__(self, journal: RequestJournal, after_seq: int = -1) -> None:
        self._journal = journal
        self.seq = int(after_seq)  # last seq handed out
        self._path: Optional[str] = None
        self._first = 0  # first seq of the current segment
        self._next = 0  # seq of the next frame at _offset
        self._offset = 0  # byte offset of the next frame in the current segment

    def _locate(self) -> bool:
        """Point at the first segment not wholly covered by ``self.seq``."""
        segs = self._journal._segments()
        for i, (first, path) in enumerate(segs):
            nxt = segs[i + 1][0] if i + 1 < len(segs) else None
            if nxt is not None and nxt - 1 <= self.seq:
                continue
            self._path, self._first, self._next, self._offset = path, first, first, 0
            return True
        return False

    def read(self, max_records: Optional[int] = None) -> List[Tuple[int, bytes]]:
        """Every intact record appended since the last poll (bounded by
        ``max_records``), as ``(seq, payload)`` in order."""
        with self._journal._lock:
            if self._journal._file is not None:
                self._journal._file.flush()
        out: List[Tuple[int, bytes]] = []
        relocated = False
        while True:
            if self._path is None and not self._locate():
                return out
            try:
                with open(self._path, "rb") as f:
                    f.seek(self._offset)
                    data = f.read()
            except OSError:
                # segment rotated away under us: its records were snapshot-
                # covered — re-locate (once per poll, bounding the loop under
                # a racing rotator); the caller sees the resulting seq jump.
                # Records already buffered are flushed FIRST: one read() never
                # spans a discontinuity, so a caller checking contiguity at
                # records[0] (the shipper) cannot ship across a hidden gap.
                self._path = None
                if out or relocated:
                    return out
                relocated = True
                continue
            off = 0
            while off + _FRAME.size <= len(data):
                n, crc = _FRAME.unpack_from(data, off)
                payload = data[off + _FRAME.size : off + _FRAME.size + n]
                if len(payload) != n or (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                    break  # incomplete (live append) or torn: stop at it
                if self._next > self.seq:
                    out.append((self._next, payload))
                    self.seq = self._next
                self._next += 1
                off += _FRAME.size + n
                if max_records is not None and len(out) >= max_records:
                    self._offset += off
                    return out
            self._offset += off
            nxt = None
            for first, path in self._journal._segments():
                if first > self._first and (nxt is None or first < nxt[0]):
                    nxt = (first, path)
            if len(data) - off > 0:
                if nxt is None:
                    # leftover bytes in the NEWEST segment: a live writer's
                    # in-flight frame — stop exactly at the unparsed bytes and
                    # wait for the append to land
                    return out
                # mid-history tear: a newer segment exists, so this one is
                # immutable (rotation closed its file before the next segment
                # was created) and the bytes can never complete — waiting here
                # would wedge the cursor forever, silently stalling a shipper
                # rewound below the tear with no gap signal. Hop to the next
                # segment; the seq jump surfaces at the caller's records[0]
                # contiguity check (buffered records flush FIRST so one read
                # never spans the discontinuity).
                if out:
                    return out
                self._path, self._first, self._next, self._offset = nxt[1], nxt[0], nxt[0], 0
                continue
            if nxt is None:
                return out  # newest segment: wait for appends
            if out and nxt[0] != self._next:
                # rotation GC'd the segments in between: flush what we have so
                # the seq jump lands at the START of the next read, where the
                # caller's records[0] continuity check can see it
                return out
            self._path, self._first, self._next, self._offset = nxt[1], nxt[0], nxt[0], 0
