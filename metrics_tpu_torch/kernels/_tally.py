"""Per-thread tallies of hand-kernel launches.

Each wrapper's launch counter (``confmat.launches``, ``scatter.launches``, ...)
is process-wide. A graph capture must count only the launches its own thread
made: several engines capture at once on one card (a sharded engine's shards,
each on its own dispatcher thread), and a process-wide difference taken around
one capture would take in the others' launches too.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Iterator

_thread = threading.local()


def record(name: str, n: int = 1) -> None:
    """Add ``n`` launches of kernel ``name`` to this thread's open tally, if any."""
    tally = getattr(_thread, "tally", None)
    if tally is not None:
        tally[name] = tally.get(name, 0) + n


@contextmanager
def counting() -> Iterator[Dict[str, int]]:
    """This thread's launches inside the block, by kernel name (a nested block's
    launches count in the enclosing one too)."""
    outer = getattr(_thread, "tally", None)
    tally: Dict[str, int] = {}
    _thread.tally = tally
    try:
        yield tally
    finally:
        _thread.tally = outer
        if outer is not None:
            for name, n in tally.items():
                outer[name] = outer.get(name, 0) + n
