"""LOTION's objectives (port of ``repro.core.lotion``).

The definitional smoothed loss and its closed form for quadratics:

* ``smoothed_loss_mc``: Monte-Carlo ``E_{q~RR(w)}[L(q)]`` over explicit
  uniforms (one draw of ``w``'s shape per sample);
* ``quadratic_smoothed``: Eq. 1, ``L(w) + 1/2 tr(H Sigma_eps)``;
* ``fisher_from_grads``: one EMA step of the empirical-Fisher diagonal.

The working objective, the Eq. 3 penalty (``lotion_penalty`` /
``lotion_penalty_and_grad``):

    penalty = 1/2 sum_i f_i (hi_i - w_i)(w_i - lo_i)

with ``(lo, hi)`` the representable brackets of ``w`` and ``f`` the
empirical-Fisher diagonal (always treated as a constant).  Its a.e.
gradient inside a quantization cell is ``1/2 f (lo + hi - 2w)``; the
closed form below writes it as autodiff computes it, with ``lam`` folded
into the cotangent first, so the decoupled placement reproduces the
loss-side placement's parameter updates bit for bit (DESIGN.md §2).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

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
                            block_size: int = -1, lam: float = 1.0,
                            absmax=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form (value, grad) of :func:`lotion_penalty` with a constant
    scale: ``grad = ct (hi - w) - ct (w - lo)`` with ``ct = (lam/2) f``,
    the float expression reverse-mode autodiff produces for
    ``lam * lotion_penalty``.  The value is unscaled (times ``lam`` for
    the loss-side number).  The value's terms are added in float64 and
    rounded to fp32 once, so it hardly depends on the summation order (the
    kernels add in double too); the JAX function adds in fp32.  A given
    ``absmax`` (per matrix, (n_matrices,)) sets the scales."""
    w, fisher = w.detach(), fisher.detach()
    lo, hi = quantize.rr_neighbors(w, fmt, block_size, absmax)
    terms = fisher * ((hi - w) * (w - lo))
    value = (0.5 * torch.sum(terms, dtype=torch.float64)).to(torch.float32)
    ct = (0.5 * lam) * fisher
    grad = ct * (hi - w) - ct * (w - lo)
    return value, grad


def smoothed_loss_mc(loss_fn: Callable[[torch.Tensor], torch.Tensor],
                     w: torch.Tensor, fmt, uniforms: torch.Tensor,
                     block_size: int = -1) -> torch.Tensor:
    """Monte-Carlo ``E_{q~RR(w)}[L(q)]``: the mean of ``loss_fn`` over
    ``cast_rr(w, fmt, uniforms[i])`` for each of the ``uniforms.shape[0]``
    draws (``uniforms`` has shape ``(n_samples, *w.shape)``; the JAX
    function splits a key into ``n_samples`` instead)."""
    if tuple(uniforms.shape[1:]) != tuple(w.shape):
        raise ValueError(f"uniforms {tuple(uniforms.shape)} must be "
                         f"(n_samples, *{tuple(w.shape)})")
    losses = [loss_fn(quantize.cast_rr(w, fmt, u, block_size))
              for u in uniforms]
    return torch.mean(torch.stack(losses))


def quadratic_smoothed(w: torch.Tensor, w_star: torch.Tensor,
                       H: torch.Tensor, fmt,
                       block_size: int = -1) -> torch.Tensor:
    """Eq. 1 for L(w) = 1/2 (w - w*)^T H (w - w*): ``L(w) + 1/2 tr(H
    Sigma_eps)`` with the diagonal RR covariance ``(hi - w)(w - lo)``."""
    d = w - w_star
    base = 0.5 * (d @ (H @ d))
    var = quantize.rr_variance(w, fmt, block_size)
    return base + 0.5 * torch.sum(torch.diagonal(H) * var)


def fisher_from_grads(grads: Dict[str, torch.Tensor], decay: float,
                      state: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Dict[str, torch.Tensor]:
    """One EMA step of the empirical-Fisher diagonal, leaf by leaf over a
    dict of tensors: ``F <- decay F + (1 - decay) g^2`` (zeros without
    ``state``)."""
    if state is None:
        state = {k: torch.zeros_like(g) for k, g in grads.items()}
    return {k: decay * state[k] + (1.0 - decay) * g * g
            for k, g in grads.items()}
