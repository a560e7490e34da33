"""Fused LOTION regularizer: penalty and closed-form gradient in one pass."""

from .ops import lotion_penalty_fused, lotion_penalty_fused_vg
from .ref import reg_ref

__all__ = ["lotion_penalty_fused", "lotion_penalty_fused_vg", "reg_ref"]
