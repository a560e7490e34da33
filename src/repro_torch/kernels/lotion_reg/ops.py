"""Wrappers of the ``lotion_reg`` CUDA kernel (``csrc/lotion_reg.cu``):
the Eq. 3 LOTION penalty of one leaf and its closed-form gradient in one
pass.

``lotion_penalty_fused_vg`` returns (value, grad): the decoupled,
optimizer-side entry point.  ``lotion_penalty_fused`` is the loss-side
entry point, a ``torch.autograd.Function``: its forward launches the kernel
and saves the gradient the kernel wrote, its backward returns ``g * grad``
for ``w`` and nothing for ``fisher`` (a constant), as the JAX custom VJP
does.  Both take ``lam`` (default 1, the JAX functions' case) and fold it
into the gradient as ``core.lotion.lotion_penalty_and_grad`` does, so the
loss-side and the decoupled placements add the same gradient bit for bit;
``lotion_penalty_fused`` then returns ``lam`` times the penalty.  For a CUDA tensor they launch the kernel or raise; for a CPU tensor
they take the plain version in ``ref.py``.
``lotion_penalty_fused_vg.launches`` counts
the kernel's launches (one per call, whatever the leaf's rank: a stacked
leaf's per-matrix scales ride in one launch).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ...core.formats import CodebookFormat, get_format
from ...core.quantize import matrix_axes, matrix_scales
from .. import _build
from .ref import reg_ref


def lotion_penalty_fused_vg(w: torch.Tensor, fisher: torch.Tensor,
                            fmt_name: str = "int4", block_size: int = 256,
                            lam: float = 1.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(penalty, grad) of one leaf in one pass, ``grad`` the closed-form
    a.e. derivative of ``lam`` times the penalty with a constant scale:
    the kernel for CUDA tensors, the plain version for CPU tensors.  The
    penalty is unscaled (no lam)."""
    if fisher.shape != w.shape:
        raise ValueError(f"fisher {tuple(fisher.shape)} must have w's shape "
                         f"{tuple(w.shape)}")
    if block_size == 0 or block_size < -1:
        raise ValueError(f"block_size must be -1 or positive, got {block_size}")
    w, fisher = w.detach(), fisher.detach()
    if w.device.type == "cpu":
        return reg_ref(w, fisher, fmt_name, block_size, lam)
    if w.device.type != "cuda":
        raise ValueError(f"lotion_reg runs on cuda or cpu, got {w.device}")
    _build.check_f32_cuda("lotion_reg", w, fisher)
    fmt = get_format(fmt_name)
    n = w.numel()
    grad = torch.empty_like(w)
    pen = torch.zeros((), dtype=torch.float32, device=w.device)
    if n == 0:
        return pen, grad
    scales = mat_numel = None
    if block_size == -1:
        scales = matrix_scales(w, fmt)
        mat_numel = math.prod(w.shape[a] for a in matrix_axes(w))
    gx, gy = _build.grid_for(n, n // (mat_numel or n))
    partials = torch.empty(gx * gy, dtype=torch.float64, device=w.device)
    err = _build.lib().lotion_reg_launch(
        w.data_ptr(), fisher.data_ptr(),
        None if scales is None else scales.data_ptr(), grad.data_ptr(),
        partials.data_ptr(), pen.data_ptr(), n, mat_numel or n, block_size,
        # lam / 2 folded on the host in double, as core/lotion.py folds it
        int(isinstance(fmt, CodebookFormat)), float(fmt.qmax), 0.5 * lam,
        gx, gy,
        torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(err, "lotion_reg")
    lotion_penalty_fused_vg.launches += 1
    return pen, grad


lotion_penalty_fused_vg.launches = 0


class _FusedPenalty(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, fisher, fmt_name, block_size, lam):
        pen, grad = lotion_penalty_fused_vg(w, fisher, fmt_name, block_size,
                                            lam)
        ctx.save_for_backward(grad)
        return lam * pen

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g * grad, None, None, None, None


def lotion_penalty_fused(w, fisher, fmt_name: str = "int4",
                         block_size: int = 256,
                         lam: float = 1.0) -> torch.Tensor:
    """``lam`` times the penalty as a differentiable scalar; backward is
    ``g * grad`` from the same kernel pass (no second pass over w), with
    ``lam`` already folded into ``grad``."""
    return _FusedPenalty.apply(w, fisher, fmt_name, block_size, lam)
