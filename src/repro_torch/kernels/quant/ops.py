"""Wrappers of the ``quant`` CUDA kernel (``csrc/quant.cu``): the fused
absmax scale + RTN or RR + dequantize cast of a tensor of any rank.

For a CUDA tensor they launch the kernel or raise; for a CPU tensor they
take the plain version in ``ref.py``.  ``quant_rtn.launches`` and
``quant_rr.launches`` count the kernel's launches (nothing else adds to
them).  Scales follow ``core/quantize.py``: one per matrix of a stacked
leaf for ``block_size=-1``, else contiguous blocks of the flattened tensor.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ...core.formats import CodebookFormat, get_format
from ...core.quantize import matrix_axes, matrix_scales
from .. import _build
from .ref import rr_ref, rtn_ref


def _launch(name: str, w: torch.Tensor, u: Optional[torch.Tensor],
            fmt_name: str, block_size: int) -> torch.Tensor:
    if w.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, got {w.device}")
    _build.check_f32_cuda(name, w, *(() if u is None else (u,)))
    if block_size == 0 or block_size < -1:
        raise ValueError(f"block_size must be -1 or positive, got {block_size}")
    fmt = get_format(fmt_name)
    out = torch.empty_like(w)
    n = w.numel()
    if n == 0:
        return out
    scales = mat_numel = None
    if block_size == -1:
        scales = matrix_scales(w, fmt)
        mat_numel = math.prod(w.shape[a] for a in matrix_axes(w))
    gx, gy = _build.grid_for(n, n // (mat_numel or n))
    err = _build.lib().quant_launch(
        w.data_ptr(), None if u is None else u.data_ptr(),
        None if scales is None else scales.data_ptr(), out.data_ptr(), n,
        mat_numel or n, block_size, int(isinstance(fmt, CodebookFormat)),
        float(fmt.qmax), gx, gy,
        torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(err, name)
    return out


def quant_rtn(w: torch.Tensor, fmt_name: str = "int4",
              block_size: int = 256) -> torch.Tensor:
    """Round-to-nearest cast of ``w`` (any rank), dequantized, in fp32."""
    if w.device.type == "cpu":
        return rtn_ref(w, fmt_name, block_size)
    out = _launch("quant_rtn", w, None, fmt_name, block_size)
    quant_rtn.launches += 1
    return out


def quant_rr(w: torch.Tensor, uniforms: torch.Tensor, fmt_name: str = "int4",
             block_size: int = 256) -> torch.Tensor:
    """Randomized-rounding cast of ``w`` against ``uniforms`` (``w``'s
    shape, in [0, 1)): up where ``u < (w - lo) / (hi - lo)``."""
    if uniforms.shape != w.shape:
        raise ValueError(f"uniforms {tuple(uniforms.shape)} must have w's "
                         f"shape {tuple(w.shape)}")
    if w.device.type == "cpu":
        return rr_ref(w, uniforms, fmt_name, block_size)
    out = _launch("quant_rr", w, uniforms, fmt_name, block_size)
    quant_rr.launches += 1
    return out


quant_rtn.launches = 0
quant_rr.launches = 0
