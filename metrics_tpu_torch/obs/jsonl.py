"""Shared append-only JSONL recording (a copy of ``metrics_tpu/obs/jsonl.py``).

The port's emitters (``EngineTelemetry.emit``, ``obs.Registry.emit``) delegate
here, so there is exactly one record format and one atomicity
contract: a single short ``O_APPEND`` write per record is atomic on POSIX, so
overlapping watcher + manual runs interleave whole lines instead of racing a
read-modify-write of one document. Recording must never break the run being
recorded: failures are noted on the record itself instead of raised.

Stdlib only.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict


def append_jsonl(path: str, record: Dict[str, Any]) -> None:
    """Append ``record`` as one JSON line to ``path`` (UTC-stamped, never raises)."""
    try:
        record.setdefault("utc", time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()))
        with open(path, "a") as fh:
            fh.write(json.dumps(record, default=_coerce) + "\n")
    except Exception as exc:  # noqa: BLE001 — recording must never break the caller
        record["log_error"] = repr(exc)


def _coerce(obj: Any) -> Any:
    """Last-resort JSON coercion for array scalars and other numerics.

    Registry snapshots can carry numpy/jax scalars when callers attach derived
    stats; a hard ``TypeError`` here would defeat the never-raise contract, so
    anything float()-able serializes as a number and the rest as ``repr``.
    """
    try:
        return float(obj)
    except Exception:  # noqa: BLE001
        return repr(obj)
