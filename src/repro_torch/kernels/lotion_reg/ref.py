"""Plain PyTorch version of the lotion_reg kernel: the closed form of
``core/lotion.py`` (value, grad = ct (hi - w) - ct (w - lo),
ct = (lam / 2) f), as the JAX package's ``reg_ref`` at ``lam = 1``."""

from __future__ import annotations

from ...core.formats import get_format
from ...core.lotion import lotion_penalty_and_grad


def reg_ref(w, fisher, fmt_name: str, block_size: int, lam: float = 1.0,
            absmax=None):
    return lotion_penalty_and_grad(w, fisher, get_format(fmt_name),
                                   block_size, lam=lam, absmax=absmax)
