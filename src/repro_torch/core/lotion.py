"""LOTION's working objective, the Eq. 3 penalty (port of the
``lotion_penalty`` / ``lotion_penalty_and_grad`` pair of
``repro.core.lotion``):

    penalty = 1/2 sum_i f_i (hi_i - w_i)(w_i - lo_i)

with ``(lo, hi)`` the representable brackets of ``w`` and ``f`` the
empirical-Fisher diagonal (always treated as a constant).  Its a.e.
gradient inside a quantization cell is ``1/2 f (lo + hi - 2w)``; the
closed form below writes it as autodiff computes it, with ``lam`` folded
into the cotangent first, so the decoupled placement reproduces the
loss-side placement's parameter updates bit for bit (DESIGN.md §2).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import quantize


def lotion_penalty(w: torch.Tensor, fisher: torch.Tensor, fmt,
                   block_size: int = -1,
                   differentiate_scale: bool = False) -> torch.Tensor:
    """``1/2 sum_i fisher_i (hi_i - w_i)(w_i - lo_i)``, differentiable in
    ``w`` through autograd.  The brackets are constants; with
    ``differentiate_scale=True`` the shared scale ``absmax(w)/qmax`` also
    carries its (sub)gradient."""
    fisher = fisher.detach()
    if block_size == -1:
        # a view of w, so that autograd adds the two terms' gradients
        # (from hi - w and w - lo) into one tensor before they meet the
        # rest of the model's gradient of w: the sum then has the same
        # operands and order as the closed form in
        # lotion_penalty_and_grad, and the two placements agree bitwise
        blocked, f_blocked = w.view(w.shape), fisher
        absmax = quantize._absmax_pertensor(
            w if differentiate_scale else w.detach())
    else:
        blocked, _, _ = quantize._block_view(w, block_size)
        f_blocked, _, _ = quantize._block_view(fisher, block_size)
        src = blocked if differentiate_scale else blocked.detach()
        absmax = torch.amax(torch.abs(src), dim=-1, keepdim=True)
    s = fmt.scale(absmax)
    s_const = s.detach()
    lo, hi = fmt.neighbors(blocked.detach(), s_const)
    if differentiate_scale:
        # piecewise-constant codes, re-attached to the differentiable scale
        lo = (lo / s_const).detach() * s
        hi = (hi / s_const).detach() * s
    var = (hi - blocked) * (blocked - lo)
    return 0.5 * torch.sum(f_blocked * var)


def lotion_penalty_and_grad(w: torch.Tensor, fisher: torch.Tensor, fmt,
                            block_size: int = -1, lam: float = 1.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form (value, grad) of :func:`lotion_penalty` with a constant
    scale: ``grad = ct (hi - w) - ct (w - lo)`` with ``ct = (lam/2) f``,
    the float expression reverse-mode autodiff produces for
    ``lam * lotion_penalty``.  The value is unscaled (times ``lam`` for
    the loss-side number).  The value's terms are added in float64 and
    rounded to fp32 once, so it hardly depends on the summation order (the
    kernels add in double too); the JAX function adds in fp32."""
    w, fisher = w.detach(), fisher.detach()
    lo, hi = quantize.rr_neighbors(w, fmt, block_size)
    terms = fisher * ((hi - w) * (w - lo))
    value = (0.5 * torch.sum(terms, dtype=torch.float64)).to(torch.float32)
    ct = (0.5 * lam) * fisher
    grad = ct * (hi - w) - ct * (w - lo)
    return value, grad
