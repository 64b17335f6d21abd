"""Cold tier: per-tenant ``MTCKPT1`` spill files under one directory (port of
``metrics_tpu/tier/coldstore.py``; the JAX package reads these files and the
port reads the JAX package's).

Each spilled tenant is one self-validating container blob (the snapshot
format — CRC-guarded manifest + lossless codecs, so the round trip is
bit-identical), written with the ckpt store's atomic temp+fsync+rename. File
names are content-free (a digest of the key plus a uniquifier): the residency
manifest, not the directory listing, is the source of truth for which file
belongs to which tenant — a crashed spill leaves at worst an orphaned file,
never a torn or aliased one.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Dict, Hashable, Optional, Tuple

from metrics_tpu_torch.ckpt import format as ckpt_format
from metrics_tpu_torch.ckpt.store import atomic_write


class ColdStore:
    """Spill-file manager for one engine's cold tier."""

    def __init__(self, directory: str, *, durable: bool = True) -> None:
        self.directory = os.path.abspath(directory)
        self.durable = durable
        self._seq = 0
        os.makedirs(self.directory, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    @staticmethod
    def _digest(key: Hashable) -> str:
        return hashlib.sha1(repr(key).encode("utf-8")).hexdigest()[:16]

    def spill(self, key: Hashable, entry: Dict[str, Any]) -> Tuple[str, bytes]:
        """Serialize ``entry`` and write it atomically; returns (name, blob)."""
        blob = ckpt_format.dumps(entry, meta={"kind": "tier-cold"})
        digest = self._digest(key)
        while True:
            name = f"cold-{digest}-{self._seq:08x}.mtckpt"
            self._seq += 1
            if not os.path.exists(self.path(name)):
                break
        atomic_write(self.path(name), blob, durable=self.durable)
        return name, blob

    def read_bytes(self, name: str) -> bytes:
        with open(self.path(name), "rb") as f:
            return f.read()

    def load(self, name: str) -> Dict[str, Any]:
        return ckpt_format.loads(self.read_bytes(name)).tree

    def delete(self, name: Optional[str]) -> None:
        if not name:
            return
        try:
            os.unlink(self.path(name))
        except OSError:
            pass
