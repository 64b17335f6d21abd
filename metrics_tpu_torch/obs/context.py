"""Cross-host trace context: the identity a request carries across every plane
(port of ``metrics_tpu/obs/context.py``: the same 17-byte wire block, so a WAL
record written by either package names its trace in the other).

A :class:`TraceContext` is the compact causal identity minted once per
submitted request — ``trace_id`` (the whole causal tree), ``span_id`` (this
hop), ``sampled`` (the recording bit) — and threaded through guard admission,
backlog residency, fused dispatch, the WAL, repl frames, and the ckpt journal,
so a follower's apply span and a crash-recovered engine's replay span link
back to the primary submit that caused them, across process and host
boundaries.

Propagation has three carriers:

- **in-process**: a thread-local ambient context (:func:`current` /
  :func:`activate`) — a caller that activates a context around
  ``StreamingEngine.submit`` has it adopted instead of a second one minted;
- **in-span**: span attributes (``trace=<hex>``, ``span=<hex>``) on the
  process tracer — the ring/Chrome-trace shape is unchanged, the ids ride the
  existing ``attrs`` dict;
- **on-the-wire**: a fixed 17-byte encoding (:meth:`TraceContext.to_bytes`)
  appended to WAL chunk/request records and therefore carried verbatim inside
  shipped repl frames — decoders treat the block as optional, so journals and
  spool files written before this existed (or with obs off) replay unchanged.

Disabled, nothing is minted: hot paths test ``OBS.enabled`` once and carry
``None``. Stdlib only.
"""

from __future__ import annotations

import os
import random
import struct
import threading
from typing import Any, Iterator, Optional

from metrics_tpu_torch.obs.registry import OBS

# u64 trace_id + u64 span_id + u8 flags (bit 0 = sampled)
_WIRE = struct.Struct("<QQB")
WIRE_SIZE = _WIRE.size  # 17

# Process-private id source. `random.Random` seeded from os.urandom gives
# 64-bit ids that never collide across the processes of one fleet test in
# practice, without burning an os.urandom read per request. A lock keeps the
# generator state sane under concurrent submits (getrandbits is not atomic).
_rng = random.Random(int.from_bytes(os.urandom(8), "little"))
_rng_lock = threading.Lock()

_local = threading.local()


def _fresh_id() -> int:
    with _rng_lock:
        # avoid 0: an all-zero id doubles as "absent" in the wire block
        return _rng.getrandbits(64) or 1


class TraceContext:
    """One hop of a cross-host trace: (trace_id, span_id, sampled)."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: int, span_id: int, sampled: bool = True) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    # ------------------------------------------------------------------ lineage

    def child(self) -> "TraceContext":
        """A new hop in the same trace (fresh span_id, inherited trace_id)."""
        return TraceContext(self.trace_id, _fresh_id(), self.sampled)

    # ------------------------------------------------------------------ wire

    def to_bytes(self) -> bytes:
        return _WIRE.pack(self.trace_id, self.span_id, 1 if self.sampled else 0)

    @staticmethod
    def from_bytes(data: bytes, off: int = 0) -> "TraceContext":
        trace_id, span_id, flags = _WIRE.unpack_from(data, off)
        return TraceContext(trace_id, span_id, bool(flags & 1))

    # ------------------------------------------------------------------ display

    @property
    def trace_hex(self) -> str:
        return f"{self.trace_id:016x}"

    @property
    def span_hex(self) -> str:
        return f"{self.span_id:016x}"

    def __repr__(self) -> str:
        return f"TraceContext(trace={self.trace_hex}, span={self.span_hex}, sampled={self.sampled})"

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, TraceContext):
            return NotImplemented
        return (
            self.trace_id == other.trace_id
            and self.span_id == other.span_id
            and self.sampled == other.sampled
        )

    def __hash__(self) -> int:
        return hash((self.trace_id, self.span_id, self.sampled))


def mint() -> TraceContext:
    """A brand-new root context (new trace_id). Callers gate on ``OBS.enabled``."""
    return TraceContext(_fresh_id(), _fresh_id(), True)


def current() -> Optional[TraceContext]:
    """The ambient context on THIS thread (None when nothing is active)."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


class _Activation:
    """Context manager installing one TraceContext as the thread's ambient context."""

    __slots__ = ("_ctx",)

    def __init__(self, ctx: Optional[TraceContext]) -> None:
        self._ctx = ctx

    def __enter__(self) -> Optional[TraceContext]:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self._ctx)
        return self._ctx

    def __exit__(self, *exc_info: Any) -> bool:
        stack = getattr(_local, "stack", None)
        if stack:
            stack.pop()
        return False


def activate(ctx: Optional[TraceContext]) -> _Activation:
    """Install ``ctx`` as the ambient context for a ``with`` block.

    ``activate(None)`` is a valid (and cheap) no-op shadowing — engines use it
    unconditionally so the disabled path stays branch-free at the call site.
    """
    return _Activation(ctx)


def mint_or_current() -> Optional[TraceContext]:
    """The propagation rule engines apply at submit: adopt the ambient context
    if a caller (a user span, a test) activated one, else mint a
    fresh root — and only when obs is on."""
    if not OBS.enabled:
        return None
    ctx = current()
    return ctx if ctx is not None else mint()


def trace_attrs(ctx: Optional[TraceContext]) -> dict:
    """Span-attribute dict carrying the ids (empty when no context)."""
    if ctx is None:
        return {}
    return {"trace": ctx.trace_hex, "span": ctx.span_hex}


def iter_wire_blocks(payload: bytes, off: int) -> Iterator[TraceContext]:
    """Decode consecutive wire blocks from ``payload[off:]`` until exhausted.

    The optional-trailer convention: WAL decoders call this with the offset
    where positional decoding finished — zero remaining bytes (an old record,
    or obs-off writer) yields nothing.
    """
    while off + WIRE_SIZE <= len(payload):
        yield TraceContext.from_bytes(payload, off)
        off += WIRE_SIZE
