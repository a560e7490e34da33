"""Plain PyTorch version of the quant kernel: the core casts themselves
(``core/quantize.py``), which the CPU tests hold to the JAX package's;
``absmax`` (per matrix) gives the scales' absmax instead of ``w``'s own."""

from __future__ import annotations

import torch

from ...core import quantize
from ...core.formats import get_format


def rtn_ref(w: torch.Tensor, fmt_name: str, block_size: int,
            absmax=None) -> torch.Tensor:
    return quantize.cast_rtn(w, get_format(fmt_name), block_size, absmax)


def rr_ref(w: torch.Tensor, uniforms: torch.Tensor, fmt_name: str,
           block_size: int, absmax=None) -> torch.Tensor:
    return quantize.cast_rr(w, get_format(fmt_name), uniforms, block_size,
                            absmax)
