"""Fused clip + LOTION + AdamW/SGD optimizer step, one pass per leaf."""

from .ops import fused_opt_step_leaf, step_scalars
from .ref import opt_step_ref

__all__ = ["fused_opt_step_leaf", "opt_step_ref", "step_scalars"]
