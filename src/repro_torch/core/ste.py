"""Straight-through estimators for the QAT and RAT baselines (port of
``repro.core.ste``).

QAT (paper §4): the forward pass uses the RTN-cast weights and the
backward pass treats the quantizer as the identity.  RAT: the same, with
randomized rounding in the forward pass, against explicit uniforms.

One ``torch.autograd.Function`` is the whole estimator: its forward is the
cast through the ``quant`` kernel's wrappers (the CUDA kernel for CUDA
tensors, the plain version for CPU tensors) and its backward hands the
upstream gradient to ``w`` unchanged, as JAX's ``_ste_bwd`` does.  It
saves nothing for backward: the cast copy it returns is the only memory
it adds.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.quant import quant_rr, quant_rtn


class _STECast(torch.autograd.Function):
    """``cast(w)`` forward, identity backward to ``w``."""

    @staticmethod
    def forward(ctx, w: torch.Tensor, fmt_name: str, block_size: int,
                uniforms: Optional[torch.Tensor],
                absmax: Optional[torch.Tensor]) -> torch.Tensor:
        if uniforms is None:
            return quant_rtn(w, fmt_name, block_size, absmax)
        return quant_rr(w, uniforms, fmt_name, block_size, absmax)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None, None, None, None


def _fmt_name(fmt) -> str:
    return fmt if isinstance(fmt, str) else fmt.name


def fake_quant_rtn(w: torch.Tensor, fmt, block_size: int = -1,
                   absmax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """QAT fake-quant: RTN forward, identity backward (``absmax``: the
    per-matrix absmax of a sharded leaf's whole matrices)."""
    return _STECast.apply(w, _fmt_name(fmt), block_size, None, absmax)


def fake_quant_rr(w: torch.Tensor, fmt, uniforms: torch.Tensor,
                  block_size: int = -1,
                  absmax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RAT fake-quant: randomized rounding against ``uniforms`` (``w``'s
    shape, in [0, 1)) forward, identity backward."""
    return _STECast.apply(w, _fmt_name(fmt), block_size, uniforms, absmax)
