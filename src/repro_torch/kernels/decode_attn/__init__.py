"""Fused decode attention over an int8 / packed-int4 ring KV cache
(``decode_attn``) or paged KV pool (``decode_attn_paged``)."""

from .ops import decode_attn, decode_attn_paged
from .ref import (decode_attn_paged_ref, decode_attn_ref, gather_pool_ref,
                  ring_validity, unpack_int4_ref)

__all__ = ["decode_attn", "decode_attn_ref", "decode_attn_paged",
           "decode_attn_paged_ref", "gather_pool_ref", "ring_validity",
           "unpack_int4_ref"]
