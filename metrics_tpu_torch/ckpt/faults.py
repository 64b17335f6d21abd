"""Fault-injection doubles for durability testing: torn writes, bit flips,
partial manifests, disk-full (port of ``metrics_tpu/ckpt/faults.py``).

Used by the durability tests to prove the recovery invariant: no matter where a write is interrupted or what a
single corruption hits, :meth:`SnapshotStore.latest_valid` recovers the newest
*intact* generation and never a corrupt one.

The corruptors operate on committed snapshot files in place — exactly the
artifacts a real crash or silent media error would leave:

- :func:`tear` — truncate the file at a byte offset (a write that died
  mid-flight, after the rename was replayed from the journal of a simpler
  non-atomic writer, or a partially synced page);
- :func:`flip_bit` — invert one bit (silent media/DMA corruption);
- :func:`strip_payloads` — keep the header + manifest, drop payload bytes (a
  "partial manifest" file: metadata intact, data gone);
- :class:`DiskFull` — patches the store's atomic writer so the data write
  raises ``ENOSPC`` after ``allow`` successful commits, verifying a failed
  commit never leaves a visible torn generation behind.
"""

from __future__ import annotations

import errno
import os
import struct
from typing import Optional

from metrics_tpu_torch.ckpt import store as _store
from metrics_tpu_torch.ckpt.format import MAGIC

__all__ = ["DiskFull", "flip_bit", "strip_payloads", "tear"]


def tear(path: str, keep_bytes: Optional[int] = None, frac: float = 0.5) -> int:
    """Truncate ``path`` to ``keep_bytes`` (default: ``frac`` of its size).

    Returns the resulting size. ``keep_bytes=0`` leaves an empty file — the
    most extreme torn write.
    """
    size = os.path.getsize(path)
    keep = int(size * frac) if keep_bytes is None else int(keep_bytes)
    keep = max(0, min(keep, size))
    with open(path, "r+b") as f:
        f.truncate(keep)
    return keep


def flip_bit(path: str, offset: Optional[int] = None, bit: int = 0) -> int:
    """Invert one bit of ``path`` (default: middle byte). Returns the offset."""
    size = os.path.getsize(path)
    if size == 0:
        return 0
    off = (size // 2) if offset is None else int(offset) % size
    with open(path, "r+b") as f:
        f.seek(off)
        byte = f.read(1)
        f.seek(off)
        f.write(bytes([byte[0] ^ (1 << (bit % 8))]))
    return off


def strip_payloads(path: str) -> int:
    """Truncate ``path`` right after its manifest: header + metadata survive,
    every payload byte is gone. Returns the resulting size."""
    with open(path, "rb") as f:
        head = f.read(len(MAGIC) + 12)
    if len(head) < len(MAGIC) + 12 or head[: len(MAGIC)] != MAGIC:
        raise ValueError(f"{path} is not a snapshot file")
    (mlen,) = struct.unpack_from("<Q", head, len(MAGIC))
    keep = len(MAGIC) + 12 + mlen
    with open(path, "r+b") as f:
        f.truncate(keep)
    return keep


class DiskFull:
    """Context manager: the store's atomic write raises ``ENOSPC`` after
    ``allow`` successful commits. The refused write must leave no visible
    generation (the temp file never reaches its final name)."""

    def __init__(self, allow: int = 0) -> None:
        self.allow = int(allow)
        self.refused = 0
        self._orig = None

    def __enter__(self) -> "DiskFull":
        self._orig = _store.atomic_write

        def failing(path: str, data: bytes, *, durable: bool = True) -> None:
            if self.allow > 0:
                self.allow -= 1
                return self._orig(path, data, durable=durable)
            self.refused += 1
            raise OSError(errno.ENOSPC, "No space left on device (injected)")

        _store.atomic_write = failing
        return self

    def __exit__(self, *exc_info: object) -> None:
        _store.atomic_write = self._orig
