"""Plain PyTorch version of the fused optimizer step: the per-leaf math of
the unfused ``clip -> lotion_decoupled -> adamw_core`` (or ``sgd_core``)
chain with the step scalars precomputed, op for op as the JAX package's
``opt_step_ref``.  It is also the fused cores' path for CPU tensors.

Its square root and its divisions round as IEEE operations on every device
(``repro_torch.numerics``), as XLA's and the kernel's do.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...core.formats import get_format
from ...core.lotion import lotion_penalty_and_grad
from ...numerics import scalar, sqrt_rn


def opt_step_ref(w, g, mu, nu, *, lr, bc1, bc2, clip_scale,
                 lam: float, fmt_name: str, block_size: int,
                 b1: float, b2: float, eps: float,
                 weight_decay: float, core: str = "adamw",
                 momentum: float = 0.0, fisher_decay=None,
                 ok=None, absmax=None) -> Tuple:
    """Returns ``(new_w, new_mu, new_nu, pen)``, new tensors; ``pen`` is the
    UNSCALED penalty (0 when ``lam == 0``).  ``ok`` = 0 returns (w, mu, nu)
    unchanged, the non-finite skip gate.  ``absmax`` (per matrix) gives
    the penalty's scales instead of ``w``'s own absmax."""
    dev = w.device
    lr, bc1, bc2, clip_scale = (scalar(x, dev)
                                for x in (lr, bc1, bc2, clip_scale))
    g = g * clip_scale
    if lam != 0.0:
        pen, grad = lotion_penalty_and_grad(
            w, nu, get_format(fmt_name), block_size, lam=lam, absmax=absmax)
        g = g + grad
    else:
        pen = torch.zeros((), dtype=torch.float32, device=dev)
    if core == "adamw":
        mu2 = b1 * mu + (1 - b1) * g
        nu2 = b2 * nu + (1 - b2) * g * g
        upd = (mu2 / bc1) / (sqrt_rn(nu2 / bc2) + eps)
        new_w = w - lr * (upd + weight_decay * w)
    elif core == "sgd":
        nu2 = (fisher_decay * nu + (1 - fisher_decay) * g * g
               if fisher_decay is not None else nu)
        if momentum:
            mu2 = momentum * mu + g
            step = mu2
        else:
            mu2 = mu
            step = g
        new_w = w - lr * step
    else:
        raise ValueError(f"core must be 'adamw' or 'sgd', got {core!r}")
    if ok is not None:
        keep = scalar(ok, dev) != 0.0
        new_w = torch.where(keep, new_w, w)
        mu2 = torch.where(keep, mu2, mu)
        nu2 = torch.where(keep, nu2, nu)
    return new_w, mu2, nu2, pen.to(torch.float32)
