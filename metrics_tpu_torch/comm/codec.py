"""Codec layer: how a state leaf is represented on the wire
(port of ``metrics_tpu/comm/codec.py``).

A codec turns one array leaf into one or more *payload* arrays (the bytes a
snapshot or a collective actually moves) plus enough static metadata to invert
the mapping. Three codecs:

- :class:`LosslessCodec` — identity passthrough; the default for everything.
  Bit-identical round trip, wire bytes == raw bytes.
- :class:`Fp16Codec` — fp32 → fp16 cast. Round-trip error ≤ ``2**-11 · |x|``
  for values in fp16 normal range (plus the 2**-24 subnormal quantum near 0).
- :class:`Int8BlockCodec` — blockwise absmax quantization: the flat leaf is
  split into blocks of ``block`` elements, each block ships int8 codes plus one
  fp32 scale (``absmax/127``). Round-trip error ≤ ``absmax_block / 254`` per
  element (round-to-nearest of ``x/scale``).

Which leaf gets which codec is the :class:`CodecPolicy`'s call — dtype- and
reduction-aware: integer/bool leaves and ``_update_count`` are always lossless
(counts must stay exact), small leaves are not worth the scale overhead, and
reducible fp32 states (``sum``/``mean``/...) stay lossless unless explicitly
opted in — only large float ``cat``/gather states quantize by default.

Host-path ``encode``/``decode`` are numpy on the host, as the snapshot format
and the transports are: float32 division and round-half-even (``np.rint``), so
the int8 codes and scales are the JAX package's bit for bit on the same input.
:meth:`Int8BlockCodec.encode_in_trace` / ``decode_in_trace`` are their torch
twins on a tensor of any device, for quantized collectives
(:func:`metrics_tpu_torch.comm.plane.reduce_in_trace` with a codec): the same
float32 division, ``torch.round`` (half to even, as ``jnp.round``) and the
clamp to ±127.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "Codec",
    "CodecPolicy",
    "EncodedLeaf",
    "Fp16Codec",
    "Int8BlockCodec",
    "LosslessCodec",
    "get_codec",
    "register_codec",
]


@dataclass
class EncodedLeaf:
    """One leaf's wire representation: payload arrays + inversion metadata."""

    codec: str
    payloads: Tuple[np.ndarray, ...]
    shape: Tuple[int, ...]
    dtype: np.dtype

    @property
    def wire_nbytes(self) -> int:
        return sum(int(p.nbytes) for p in self.payloads)

    @property
    def raw_nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * np.dtype(self.dtype).itemsize


class Codec:
    """Invertible (up to a documented bound) wire representation of one leaf."""

    name = "codec"
    lossless = False

    def encode(self, x: np.ndarray) -> EncodedLeaf:
        raise NotImplementedError

    def decode(self, enc: EncodedLeaf) -> np.ndarray:
        raise NotImplementedError

    def payload_specs(self, shape: Tuple[int, ...], dtype: np.dtype) -> List[Tuple[Tuple[int, ...], np.dtype]]:
        """Static (shape, dtype) of each payload for a leaf of ``shape``/``dtype``."""
        raise NotImplementedError


class LosslessCodec(Codec):
    """Identity passthrough — one payload, the leaf itself."""

    name = "lossless"
    lossless = True

    def encode(self, x: np.ndarray) -> EncodedLeaf:
        x = np.asarray(x)
        return EncodedLeaf(self.name, (x,), tuple(x.shape), x.dtype)

    def decode(self, enc: EncodedLeaf) -> np.ndarray:
        return np.asarray(enc.payloads[0]).reshape(enc.shape).astype(enc.dtype, copy=False)

    def payload_specs(self, shape: Tuple[int, ...], dtype: np.dtype) -> List[Tuple[Tuple[int, ...], np.dtype]]:
        return [(tuple(shape), np.dtype(dtype))]


class Fp16Codec(Codec):
    """Float → fp16 cast. Error ≤ ``2**-11·|x|`` in fp16 normal range."""

    name = "fp16"
    lossless = False

    def encode(self, x: np.ndarray) -> EncodedLeaf:
        x = np.asarray(x)
        return EncodedLeaf(self.name, (x.astype(np.float16),), tuple(x.shape), x.dtype)

    def decode(self, enc: EncodedLeaf) -> np.ndarray:
        return np.asarray(enc.payloads[0]).reshape(enc.shape).astype(enc.dtype, copy=False)

    def payload_specs(self, shape: Tuple[int, ...], dtype: np.dtype) -> List[Tuple[Tuple[int, ...], np.dtype]]:
        return [(tuple(shape), np.dtype(np.float16))]


class Int8BlockCodec(Codec):
    """Blockwise absmax int8: codes (int8, block-padded flat) + scales (fp32/block).

    Per-element round-trip error ≤ ``absmax_block / 254``: with
    ``scale = absmax/127``, round-to-nearest loses at most ``scale/2``.
    All-zero blocks use scale 1 and reconstruct exactly.
    """

    lossless = False

    def __init__(self, block: int = 1024) -> None:
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self.block = int(block)
        self.name = f"int8x{self.block}"

    def _padded_len(self, n: int) -> int:
        return ((n + self.block - 1) // self.block) * self.block if n else 0

    def encode(self, x: np.ndarray) -> EncodedLeaf:
        x = np.asarray(x)
        flat = x.astype(np.float32, copy=False).ravel()
        n = flat.size
        padded = self._padded_len(n)
        if padded == 0:
            return EncodedLeaf(
                self.name,
                (np.zeros((0,), np.int8), np.zeros((0,), np.float32)),
                tuple(x.shape),
                x.dtype,
            )
        if padded != n:
            flat = np.concatenate([flat, np.zeros(padded - n, np.float32)])
        blocks = flat.reshape(-1, self.block)
        absmax = np.max(np.abs(blocks), axis=1)
        scales = np.where(absmax > 0, absmax / np.float32(127.0), np.float32(1.0)).astype(np.float32)
        codes = np.clip(np.rint(blocks / scales[:, None]), -127, 127).astype(np.int8)
        return EncodedLeaf(self.name, (codes.ravel(), scales), tuple(x.shape), x.dtype)

    def decode(self, enc: EncodedLeaf) -> np.ndarray:
        codes, scales = enc.payloads
        n = int(np.prod(enc.shape, dtype=np.int64))
        if n == 0:
            return np.zeros(enc.shape, enc.dtype)
        blocks = np.asarray(codes, np.float32).reshape(-1, self.block) * np.asarray(scales, np.float32)[:, None]
        return blocks.ravel()[:n].reshape(enc.shape).astype(enc.dtype, copy=False)

    def payload_specs(self, shape: Tuple[int, ...], dtype: np.dtype) -> List[Tuple[Tuple[int, ...], np.dtype]]:
        n = int(np.prod(shape, dtype=np.int64))
        padded = self._padded_len(n)
        return [((padded,), np.dtype(np.int8)), ((padded // self.block,), np.dtype(np.float32))]

    # ------------------------------------------------------------ in-trace twins

    def encode_in_trace(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Torch version of :meth:`encode` on ``x``'s own device.

        Returns ``(codes, scales)`` with codes flat-per-block (int8, block-padded)
        and one float32 scale a block — the caller gathers both and calls
        :meth:`decode_in_trace`. Shapes depend only on ``x.shape``, so the call
        can be captured in a CUDA graph.
        """
        flat = x.reshape(-1).to(torch.float32)
        n = flat.numel()
        padded = self._padded_len(n)
        if padded != n:
            flat = torch.cat([flat, flat.new_zeros(padded - n)])
        blocks = flat.reshape(-1, self.block)
        absmax = blocks.abs().amax(dim=1)
        scales = torch.where(absmax > 0, absmax / 127.0, 1.0)
        codes = torch.clamp(torch.round(blocks / scales[:, None]), -127, 127).to(torch.int8)
        return codes.reshape(-1), scales

    def decode_in_trace(self, codes: torch.Tensor, scales: torch.Tensor, n: int, target_dtype: torch.dtype) -> torch.Tensor:
        """Invert :meth:`encode_in_trace` back to a flat length-``n`` trailing axis.

        Batch-aware: leading axes (the world axis of an all-gather) pass through
        — ``(..., padded)`` codes and ``(..., blocks)`` scales decode to ``(..., n)``.
        """
        lead = codes.shape[:-1]
        blocks = codes.to(torch.float32).reshape(*lead, -1, self.block) * scales[..., None]
        return blocks.reshape(*lead, -1)[..., :n].to(target_dtype)


_CODECS: Dict[str, Codec] = {}


def register_codec(codec: Codec) -> Codec:
    """Add a codec to the by-name registry (used by policies and plans)."""
    _CODECS[codec.name] = codec
    return codec


register_codec(LosslessCodec())
register_codec(Fp16Codec())
register_codec(Int8BlockCodec())  # int8x1024, the default lossy codec
# aliases so policies can say "int8"/"fp16" without knowing the block size
_CODECS["int8"] = _CODECS["int8x1024"]


def get_codec(name: str) -> Codec:
    try:
        return _CODECS[name]
    except KeyError:
        raise KeyError(f"unknown codec {name!r}; registered: {sorted(_CODECS)}") from None


_REDUCIBLE = ("sum", "mean", "max", "min")


@dataclass(frozen=True)
class CodecPolicy:
    """Per-leaf codec choice, dtype- and reduction-aware.

    ``lossy=None`` (the default) keeps every leaf lossless. With
    ``lossy="int8"`` (or ``"fp16"``), large floating-point gather-style leaves
    (``cat``/``None``/callable reductions) quantize; counts, integer/bool
    dtypes, ``_update_count`` and anything under ``min_bytes`` stay lossless,
    and reducible float states only quantize when ``quantize_reducible=True``.
    """

    lossy: Optional[str] = None
    min_bytes: int = 4096
    quantize_reducible: bool = False

    def choose(self, name: str, reduction: Any, dtype: Any, nbytes: int) -> str:
        if self.lossy is None:
            return "lossless"
        if name == "_update_count":
            return "lossless"
        kind = np.dtype(dtype).kind
        if kind not in ("f", "c") or np.dtype(dtype).itemsize < 4:
            return "lossless"  # ints/bools/already-half: exactness beats bytes
        if nbytes < self.min_bytes:
            return "lossless"
        if isinstance(reduction, str) and reduction in _REDUCIBLE and not self.quantize_reducible:
            return "lossless"
        return self.lossy

    def all_lossless(self) -> "CodecPolicy":
        """The degradation-ladder step-1 variant of this policy."""
        return replace(self, lossy=None)
