"""Synthetic models of the paper's toy experiments (port of
``repro.models.linear``; §4.1, §4.2).

* Linear regression with a power-law-spectrum Gaussian input covariance
  (lambda_i ∝ i^-1.1, d = 12000 in the paper): a quadratic population
  loss whose Hessian is H = diag(spectrum).
* The two-layer linear network f(x) = (1/k) W2 W1 x (width study).

Both have closed-form population losses, as in the JAX package.
Randomness enters through an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..numerics import div_scalar


def power_law_spectrum(d: int, alpha: float = 1.1,
                       device=None) -> torch.Tensor:
    """Eigenvalues lambda_i = 1/i^alpha (descending, max 1), computed in
    float64 and cast to float32 once, as the JAX function does."""
    spec = 1.0 / np.arange(1, d + 1, dtype=np.float64) ** alpha
    return torch.from_numpy(spec.astype(np.float32)).to(device)


# --- linear regression (quadratic loss) -----------------------------------

def linreg_init(d: int, device=None) -> Dict[str, torch.Tensor]:
    return {"w": torch.zeros((d,), dtype=torch.float32, device=device)}


def linreg_population_loss(w: torch.Tensor, w_star: torch.Tensor,
                           spectrum: torch.Tensor) -> torch.Tensor:
    """E_x[(w^T x - w*^T x)^2] / 2 with the diagonal covariance
    ``spectrum`` (in the covariance's eigenbasis)."""
    d = w - w_star
    return 0.5 * torch.sum(spectrum * d * d)


def linreg_batch_loss(w: torch.Tensor, x: torch.Tensor,
                      y: torch.Tensor) -> torch.Tensor:
    pred = x @ w
    return 0.5 * torch.mean((pred - y) ** 2)


# --- two-layer linear network (§4.2) ---------------------------------------

def twolayer_init(gen: torch.Generator, d: int, k: int,
                  device=None) -> Dict[str, torch.Tensor]:
    """W1 ~ N(0, 1/d) of shape (k, d), W2 ~ N(0, 1) of shape (1, k),
    drawn in that order from ``gen`` (on ``gen``'s device unless given)."""
    device = device if device is not None else gen.device
    w1 = torch.randn((k, d), generator=gen, device=device)
    w2 = torch.randn((1, k), generator=gen, device=device)
    return {"w1": div_scalar(w1, float(np.sqrt(d))), "w2": w2}


def twolayer_effective(params, k: int) -> torch.Tensor:
    """The effective linear predictor v = (1/k) W2 W1, shape (d,)."""
    return div_scalar((params["w2"] @ params["w1"])[0], float(k))


def twolayer_population_loss(params, w_star: torch.Tensor,
                             spectrum: torch.Tensor, k: int) -> torch.Tensor:
    d = twolayer_effective(params, k) - w_star
    return 0.5 * torch.sum(spectrum * d * d)


def twolayer_ground_truth(w_star: torch.Tensor,
                          k: int) -> Dict[str, torch.Tensor]:
    """The paper's GT construction: W2 = ones, rows of W1 = w* (Lemma 4)."""
    return {"w1": w_star[None, :].repeat(k, 1).contiguous(),
            "w2": torch.ones((1, k), dtype=torch.float32,
                             device=w_star.device)}
