"""Fused absmax-scale + RTN / RR + dequantize cast (the eval casts)."""

from .ops import quant_rr, quant_rtn
from .ref import rr_ref, rtn_ref

__all__ = ["quant_rtn", "quant_rr", "rtn_ref", "rr_ref"]
