"""Fused decode attention over an int8 / packed-int4 ring KV cache."""

from .ops import decode_attn
from .ref import decode_attn_ref, ring_validity, unpack_int4_ref

__all__ = ["decode_attn", "decode_attn_ref", "ring_validity",
           "unpack_int4_ref"]
