"""Snapshot wire format: versioned manifest + checksummed, codec'd host leaves
(port of ``metrics_tpu/ckpt/format.py``; the same bytes for the same tree).

One snapshot is one byte blob::

    magic "MTCKPT1\\n" | manifest_len (u64 LE) | manifest_crc32 (u32 LE)
    | manifest (UTF-8 JSON) | payload bytes (concatenated)

The manifest carries ``format_version`` (this container layout),
``schema_version`` (the *payload* schema — bumped by producers, bridged by
:mod:`metrics_tpu_torch.ckpt.restore`'s migration registry), free-form ``meta``, a
JSON skeleton of the state pytree, and one entry per binary leaf recording the
original dtype/shape, the codec that produced the wire payloads, and a CRC32
per payload. Every integrity failure — bad magic, truncation, a manifest or
payload CRC mismatch, an undecodable manifest — raises
:class:`CorruptSnapshotError`, which is the signal the store's generation scan
keys on (a torn or bit-flipped snapshot is *skipped*, never half-restored).

Leaves ride the comm codec layer (:mod:`metrics_tpu_torch.comm.codec`): the default
:class:`~metrics_tpu_torch.comm.codec.CodecPolicy` keeps every leaf lossless
(bit-identical round trip, the acceptance bar); an opted-in lossy policy
quantizes exactly the leaves the comm plane would (dtype- and
reduction-aware — counts and ``_update_count`` stay exact, same bounds as
documented for the codecs).

Tree handling is structural, not pickled: dicts (string keys), lists, tuples,
``None``, JSON scalars and array-likes round-trip natively; anything else
(tenant-key maps with non-string keys, detection's host RLE tuples) falls back
to a checksummed pickle *object leaf* — still integrity-checked, just opaque.
"""

from __future__ import annotations

import json
import pickle
import struct
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from metrics_tpu_torch.comm.codec import CodecPolicy, EncodedLeaf, get_codec

MAGIC = b"MTCKPT1\n"
FORMAT_VERSION = 1
_HEADER = struct.Struct("<QI")  # manifest nbytes, manifest crc32

__all__ = [
    "FORMAT_VERSION",
    "MAGIC",
    "CorruptSnapshotError",
    "Snapshot",
    "dumps",
    "loads",
    "read_manifest",
]


class CorruptSnapshotError(Exception):
    """The blob is not a valid snapshot: bad magic, truncated, or a CRC failed."""


@dataclass
class Snapshot:
    """A decoded snapshot: the reconstructed tree plus its manifest identity."""

    tree: Any
    meta: Dict[str, Any]
    schema_version: int
    format_version: int
    manifest: Dict[str, Any] = field(repr=False, default_factory=dict)


def _crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _dtype_name(dtype: Any) -> str:
    """A leaf's dtype as the manifest names it: numpy's name, except for text
    (``BootStrapper``'s ``_sampling_strategy``), named by ``dtype.str``
    (``<U11``), which ``np.dtype`` parses in either package; numpy's name for
    it (``str352``) parses nowhere (ROADMAP C.15)."""
    dtype = np.dtype(dtype)
    return dtype.str if dtype.kind in "US" else dtype.name


_TEXT_NAMES = {"str": ("<U", 32), "bytes": ("|S", 8)}  # numpy's name of a text dtype: its width in bits


def _dtype_from_name(name: str) -> np.dtype:
    try:
        return np.dtype(name)
    except TypeError:
        pass
    for prefix, (code, bits) in _TEXT_NAMES.items():
        if name.startswith(prefix) and name[len(prefix):].isdigit():
            return np.dtype(f"{code}{int(name[len(prefix):]) // bits}")  # the JAX package's writer's name
    # extension dtypes (bfloat16 et al.) register under ml_dtypes, which the
    # JAX package always ships with and a PyTorch installation may not have:
    # imported only when a snapshot names such a dtype
    try:
        import ml_dtypes
    except ImportError:
        raise CorruptSnapshotError(
            f"snapshot leaf dtype {name!r} needs the ml_dtypes package, which is not installed"
        ) from None
    try:
        return np.dtype(getattr(ml_dtypes, name))
    except (AttributeError, TypeError):
        raise CorruptSnapshotError(f"unknown snapshot leaf dtype {name!r}") from None


def _is_array(x: Any) -> bool:
    # duck-typed so np.ndarray and np.generic qualify without importing any
    # framework here (the format must stay loadable host-side). Callers hand
    # numpy leaves: a tensor on a device cannot become numpy here
    return hasattr(x, "dtype") and hasattr(x, "shape") and hasattr(x, "__array__")


class _Writer:
    """Accumulates payload bytes + leaf records while walking the tree."""

    def __init__(self, policy: CodecPolicy, reductions: Dict[str, Any]) -> None:
        self.policy = policy
        self.reductions = reductions
        self.leaves: List[Dict[str, Any]] = []
        self.chunks: List[bytes] = []
        self.offset = 0

    def _add_payload(self, data: bytes) -> Dict[str, Any]:
        rec = {"off": self.offset, "n": len(data), "crc": _crc(data)}
        self.chunks.append(data)
        self.offset += len(data)
        return rec

    def add_array(self, x: Any, name: str) -> int:
        arr = np.asarray(x)
        codec_name = self.policy.choose(
            name, self.reductions.get(name), arr.dtype, int(arr.nbytes)
        )
        enc = get_codec(codec_name).encode(arr)
        payloads = []
        for p in enc.payloads:
            p = np.ascontiguousarray(p)
            rec = self._add_payload(p.tobytes())
            rec["dtype"] = _dtype_name(p.dtype)
            rec["shape"] = list(p.shape)
            payloads.append(rec)
        self.leaves.append(
            {
                "kind": "array",
                "dtype": _dtype_name(arr.dtype),
                "shape": list(arr.shape),
                "codec": enc.codec,
                "payloads": payloads,
            }
        )
        return len(self.leaves) - 1

    def add_object(self, x: Any) -> int:
        rec = self._add_payload(pickle.dumps(x, protocol=pickle.HIGHEST_PROTOCOL))
        self.leaves.append({"kind": "object", "payloads": [rec]})
        return len(self.leaves) - 1


def _encode_node(x: Any, name: str, w: _Writer) -> Any:
    """Tree node -> JSON skeleton; binary/opaque leaves go through the writer.

    ``name`` is the nearest enclosing dict key — the identity the codec policy
    keys its exactness rules on (``_update_count`` and friends).
    """
    if x is None:
        return {"t": "n"}
    # arrays before scalars: np.float64 subclasses float (and np.generic
    # scalars carry a dtype worth preserving exactly)
    if _is_array(x):
        return {"t": "a", "i": w.add_array(x, name)}
    if isinstance(x, bool):  # before int: bool is an int subclass
        return {"t": "p", "v": x}
    if isinstance(x, (int, float, str)):
        return {"t": "p", "v": x}
    if isinstance(x, dict):
        if all(isinstance(k, str) for k in x):
            return {"t": "d", "k": list(x.keys()), "v": [_encode_node(v, k, w) for k, v in x.items()]}
        return {"t": "o", "i": w.add_object(x)}  # non-string keys: opaque
    if isinstance(x, (list, tuple)):
        return {
            "t": "l" if isinstance(x, list) else "t",
            "v": [_encode_node(v, name, w) for v in x],
        }
    return {"t": "o", "i": w.add_object(x)}


def _decode_node(node: Dict[str, Any], leaves: List[Any]) -> Any:
    t = node["t"]
    if t == "n":
        return None
    if t == "p":
        return node["v"]
    if t == "a" or t == "o":
        return leaves[node["i"]]
    if t == "d":
        return dict(zip(node["k"], (_decode_node(v, leaves) for v in node["v"])))
    if t == "l":
        return [_decode_node(v, leaves) for v in node["v"]]
    if t == "t":
        return tuple(_decode_node(v, leaves) for v in node["v"])
    raise CorruptSnapshotError(f"unknown skeleton node type {t!r}")


def dumps(
    tree: Any,
    *,
    policy: Optional[CodecPolicy] = None,
    reductions: Optional[Dict[str, Any]] = None,
    schema_version: int = 1,
    meta: Optional[Dict[str, Any]] = None,
) -> bytes:
    """Serialize a state pytree into one self-validating snapshot blob.

    ``policy`` defaults to the all-lossless :class:`CodecPolicy` — the round
    trip is then bit-identical. ``reductions`` maps state *names* (the nearest
    dict key of a leaf) to their ``dist_reduce_fx`` so a lossy policy can keep
    reducible/count states exact, exactly as the comm plane does.
    """
    w = _Writer(policy if policy is not None else CodecPolicy(), reductions or {})
    skeleton = _encode_node(tree, "", w)
    manifest = {
        "format_version": FORMAT_VERSION,
        "schema_version": int(schema_version),
        "meta": meta or {},
        "skeleton": skeleton,
        "leaves": w.leaves,
        "payload_nbytes": w.offset,
    }
    mbytes = json.dumps(manifest, separators=(",", ":")).encode("utf-8")
    return b"".join([MAGIC, _HEADER.pack(len(mbytes), _crc(mbytes)), mbytes, *w.chunks])


def _split(data: bytes) -> Tuple[Dict[str, Any], bytes]:
    if len(data) < len(MAGIC) + _HEADER.size:
        raise CorruptSnapshotError(f"truncated header ({len(data)} bytes)")
    if data[: len(MAGIC)] != MAGIC:
        raise CorruptSnapshotError("bad magic — not a metrics_tpu snapshot")
    mlen, mcrc = _HEADER.unpack_from(data, len(MAGIC))
    start = len(MAGIC) + _HEADER.size
    mbytes = data[start : start + mlen]
    if len(mbytes) != mlen:
        raise CorruptSnapshotError("truncated manifest")
    if _crc(mbytes) != mcrc:
        raise CorruptSnapshotError("manifest CRC mismatch")
    try:
        manifest = json.loads(mbytes.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise CorruptSnapshotError(f"undecodable manifest: {exc}") from exc
    if manifest.get("format_version") != FORMAT_VERSION:
        raise CorruptSnapshotError(
            f"unsupported format_version {manifest.get('format_version')!r} (expected {FORMAT_VERSION})"
        )
    return manifest, data[start + mlen :]


def read_manifest(data: bytes) -> Dict[str, Any]:
    """Validate the header/manifest CRC and return the manifest — no payload work."""
    manifest, _ = _split(data)
    return manifest


def _decode_leaf(entry: Dict[str, Any], payload: bytes) -> Any:
    raw: List[bytes] = []
    for rec in entry["payloads"]:
        chunk = payload[rec["off"] : rec["off"] + rec["n"]]
        if len(chunk) != rec["n"]:
            raise CorruptSnapshotError("truncated payload (torn write)")
        if _crc(chunk) != rec["crc"]:
            raise CorruptSnapshotError("payload CRC mismatch (corrupt leaf)")
        raw.append(chunk)
    if entry["kind"] == "object":
        try:
            return pickle.loads(raw[0])
        except Exception as exc:  # noqa: BLE001 — CRC passed but unpicklable: still corrupt
            raise CorruptSnapshotError(f"undecodable object leaf: {exc}") from exc
    arrays = tuple(
        np.frombuffer(chunk, dtype=_dtype_from_name(rec["dtype"])).reshape(rec["shape"])
        for rec, chunk in zip(entry["payloads"], raw)
    )
    enc = EncodedLeaf(
        entry["codec"], arrays, tuple(entry["shape"]), _dtype_from_name(entry["dtype"])
    )
    return get_codec(entry["codec"]).decode(enc)


def verify(data: bytes) -> Dict[str, Any]:
    """Integrity-check one snapshot blob — manifest CRC + every payload chunk
    length/CRC — WITHOUT decoding any leaf (no numpy reconstruction, no codec
    decode, no unpickling). Returns the validated manifest.

    The repl shipper's pre-flight: it ships the raw bytes, so it needs the
    corruption-skip guarantee and ``meta["seq"]``, not the decoded tree —
    :func:`loads` would rebuild the whole state every checkpoint interval
    just to throw it away. Raises :class:`CorruptSnapshotError` exactly when
    :func:`loads` would for integrity failures (a CRC-clean but undecodable
    leaf — a writer bug, not corruption — is only caught by a full decode).
    """
    manifest, payload = _split(data)
    if len(payload) < int(manifest.get("payload_nbytes", 0)):
        raise CorruptSnapshotError(
            f"truncated payload region: {len(payload)} < {manifest['payload_nbytes']} bytes"
        )
    for entry in manifest["leaves"]:
        for rec in entry["payloads"]:
            chunk = payload[rec["off"] : rec["off"] + rec["n"]]
            if len(chunk) != rec["n"]:
                raise CorruptSnapshotError("truncated payload (torn write)")
            if _crc(chunk) != rec["crc"]:
                raise CorruptSnapshotError("payload CRC mismatch (corrupt leaf)")
    return manifest


def loads(data: bytes) -> Snapshot:
    """Decode + integrity-check one snapshot blob back into a host-numpy tree."""
    manifest, payload = _split(data)
    if len(payload) < int(manifest.get("payload_nbytes", 0)):
        raise CorruptSnapshotError(
            f"truncated payload region: {len(payload)} < {manifest['payload_nbytes']} bytes"
        )
    leaves = [_decode_leaf(entry, payload) for entry in manifest["leaves"]]
    tree = _decode_node(manifest["skeleton"], leaves)
    return Snapshot(
        tree=tree,
        meta=manifest.get("meta", {}),
        schema_version=int(manifest.get("schema_version", 1)),
        format_version=int(manifest["format_version"]),
        manifest=manifest,
    )
