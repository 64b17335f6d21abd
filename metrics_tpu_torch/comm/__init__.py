"""Compressed state movement (port of ``metrics_tpu/comm``: the codec layer only).

:mod:`~metrics_tpu_torch.comm.codec` says how a state leaf looks on the wire
(lossless / fp16 / blockwise int8), chosen per state by a dtype- and
reduction-aware :class:`CodecPolicy`. The snapshot format
(:mod:`metrics_tpu_torch.ckpt.format`) rides it. The transfer plans,
transports, membership and the sync plane come with ROADMAP A.8.
"""

from metrics_tpu_torch.comm.codec import (
    Codec,
    CodecPolicy,
    EncodedLeaf,
    Fp16Codec,
    Int8BlockCodec,
    LosslessCodec,
    get_codec,
    register_codec,
)

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
