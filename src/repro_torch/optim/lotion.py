"""Decoupled optimizer-side LOTION (port of ``repro.optim.lotion``): the
Eq. 3 penalty as a chain link that adds the closed-form gradient
``1/2 lam f (lo + hi - 2w)`` to the update once per step, outside
clipping and the microbatch loop.  (value, grad) come from the
``lotion_reg`` kernel (its plain version, ``core.lotion.
lotion_penalty_and_grad``, for CPU tensors) with ``lam`` folded in, so with
``clip_norm=inf`` and one microbatch it reproduces the loss-side
placement's parameter updates bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.formats import get_format
from ..core.policy import QuantPolicy, tree_leaves, tree_map, tree_map_multi
from ..kernels.lotion_reg import lotion_penalty_fused_vg
from .transform import UpdateTransform


def lotion_decoupled(fmt, lam: float, block_size: int = -1,
                     policy: Optional[QuantPolicy] = None) -> UpdateTransform:
    """Decoupled LOTION penalty link; the scaled penalty
    ``lam * 1/2 sum f (hi-w)(w-lo)`` is kept in state under ``"penalty"``."""
    fmt_name = (get_format(fmt) if isinstance(fmt, str) else fmt).name
    policy = policy if policy is not None else QuantPolicy()

    def _zero(params):
        return torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)

    def init(params):
        return {"penalty": _zero(params)}

    def update(updates, state, params=None, fisher=None, **_):
        if params is None:
            raise ValueError("lotion_decoupled needs params (chain must "
                             "pass them through)")
        if lam == 0.0:
            return updates, {"penalty": _zero(params)}
        if fisher is None:
            fisher = tree_map(torch.zeros_like, params)
        values = []

        def leaf(path, g, w, f):
            if not policy.eligible(path, w):
                return g
            value, grad = lotion_penalty_fused_vg(w, f, fmt_name, block_size,
                                                  lam)
            values.append(value)
            return g + grad

        new_updates = tree_map_multi(leaf, updates, params, fisher)
        pen = (lam * torch.sum(torch.stack(values)) if values
               else _zero(params))
        return new_updates, {"penalty": pen}

    return UpdateTransform(init=init, update=update, tag="lotion_decoupled")
