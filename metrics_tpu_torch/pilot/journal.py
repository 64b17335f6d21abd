"""Append-only CRC-framed decision journal — the pilot's flight log (port of
``metrics_tpu/pilot/journal.py``; the bytes are the JAX package's, so either
package reads the other's journal).

Every reconcile cycle appends ONE record: what was observed (including which
nodes were excluded as stale), what the policy decided and why, what the
actuator did, and how each action ended. The framing is the coordination
store's record discipline (``<II`` length+crc32 header per payload) applied
to a single append-only file, so a torn tail from a crash mid-append is
detected and dropped at read time — never half-parsed.

The journal is the post-mortem contract: :func:`read_journal` over the
directory reconstructs every action the pilot ever took, with the signal
values that justified it, without any other data source.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from typing import Any, Dict, List, Optional

__all__ = ["DecisionJournal", "read_journal", "JOURNAL_FILE"]

JOURNAL_FILE = "pilot_decisions.log"

# per-record header: payload length + crc32(payload) — the same framing the
# coordination store and WAL use, so torn/corrupt records are detectable
_CRC = struct.Struct("<II")


def _frame(doc: Dict[str, Any]) -> bytes:
    payload = json.dumps(doc, sort_keys=True, default=repr).encode("utf-8")
    return _CRC.pack(len(payload), zlib.crc32(payload)) + payload


def _scan(data: bytes) -> tuple:
    """(intact records, byte offset of the first torn/corrupt frame)."""
    out: List[Dict[str, Any]] = []
    off = 0
    while off + _CRC.size <= len(data):
        length, crc = _CRC.unpack_from(data, off)
        start = off + _CRC.size
        payload = data[start : start + length]
        if len(payload) != length or zlib.crc32(payload) != crc:
            break  # torn tail: the crash frame and anything after it is noise
        try:
            out.append(json.loads(payload.decode("utf-8")))
        except ValueError:
            break
        off = start + length
    return out, off


class DecisionJournal:
    """Append-only journal of observation→decision→action→outcome cycles."""

    def __init__(self, directory: str, filename: str = JOURNAL_FILE) -> None:
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, filename)
        self._lock = threading.Lock()
        # resume the sequence from the existing log (the pilot lease moves
        # between hosts sharing a journal directory; seqs must keep climbing)
        # — and truncate a crash-torn tail first, or every frame appended
        # after it would sit forever behind unreadable bytes
        existing: List[Dict[str, Any]] = []
        self._known = 0  # bytes of the file this journal has read or written
        if os.path.exists(self.path):
            with open(self.path, "rb") as fh:
                data = fh.read()
            existing, intact = _scan(data)
            if intact < len(data):
                with open(self.path, "r+b") as fh:
                    fh.truncate(intact)
                    fh.flush()
                    os.fsync(fh.fileno())
            self._known = intact
        self._seq = max((int(d.get("seq", -1)) for d in existing), default=-1) + 1

    def _catch_up(self) -> None:
        """Number on past records another journal appended since this one last
        read or wrote the file. A warm standby opens its journal long before
        it wins the lease; the JAX package numbers from the file as it was
        then, so the standby's first records repeat the holder's seqs."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size <= self._known:
            self._known = min(self._known, size)
            return
        with open(self.path, "rb") as fh:
            fh.seek(self._known)
            data = fh.read()
        records, intact = _scan(data)
        self._known += intact
        self._seq = max([self._seq] + [int(d.get("seq", -1)) + 1 for d in records])

    def append(self, doc: Dict[str, Any]) -> int:
        """Frame + append one cycle record; returns its sequence number.

        fsync per append: a decision record that evaporates in a crash defeats
        the journal's whole purpose, and the pilot appends at most once per
        ``evaluate_interval_s`` — durability here is off the serving hot path.
        """
        with self._lock:
            self._catch_up()
            seq = self._seq
            self._seq += 1
            framed = _frame({**doc, "seq": seq})
            with open(self.path, "ab") as fh:
                fh.write(framed)
                fh.flush()
                os.fsync(fh.fileno())
            self._known += len(framed)
            return seq


def read_journal(
    directory: str, filename: str = JOURNAL_FILE, limit: Optional[int] = None
) -> List[Dict[str, Any]]:
    """Every intact record in order; a torn/corrupt tail ends the read.

    Append-only means corruption can only be a crash-truncated tail, so
    stopping at the first bad frame loses at most the record being written
    when the process died — everything the pilot *finished* deciding is here.
    """
    path = os.path.join(directory, filename)
    if not os.path.exists(path):
        return []
    with open(path, "rb") as fh:
        data = fh.read()
    out, _ = _scan(data)
    return out if limit is None else out[:limit]
