"""AdamW and SGD(+momentum) as chainable update-transform cores, plus thin
``Optimizer`` wrappers (port of ``repro.optim.adamw``).

The cores consume gradient-convention updates and emit the (negative)
parameter step that ``apply_updates`` adds.  State is a dict whose ``nu``
(the bias-uncorrected EMA of squared gradients) is the empirical-Fisher
diagonal LOTION reads.  Step scalars (count, bias corrections, lr) stay
on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..core.policy import tree_leaves, tree_map
from ..numerics import sqrt_rn
from .transform import UpdateTransform, apply_updates


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Wrapper: params-returning update + the underlying core."""

    init: Callable
    update: Callable   # (grads, state, params) -> (new_params, new_state)
    fisher: Callable   # state -> Fisher-diagonal tree (or None)
    transform: Optional[UpdateTransform] = None


def _wrap(core: UpdateTransform) -> Optimizer:
    def update(grads, state, params):
        updates, new_state = core.update(grads, state, params)
        return apply_updates(params, updates), new_state

    return Optimizer(init=core.init, update=update, fisher=core.fisher,
                     transform=core)


def _count0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def adamw_core(lr_fn, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
               weight_decay: float = 0.0) -> UpdateTransform:
    """AdamW with decoupled weight decay."""

    def init(params):
        return {"mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params),
                "count": _count0(params)}

    def update(grads, state, params=None, **extras):
        count = state["count"] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["nu"],
                      grads)
        c = count.to(torch.float32)
        bc1 = 1 - b1 ** c
        bc2 = 1 - b2 ** c
        lr = lr_fn(count)
        # spike-cooldown LR backoff: a device scalar, no host sync
        if extras.get("lr_scale") is not None:
            lr = lr * extras["lr_scale"]

        def step(p, m, v):
            upd = (m / bc1) / (sqrt_rn(v / bc2) + eps)
            return -(lr * (upd + weight_decay * p))

        updates = tree_map(step, params, mu, nu)
        return updates, {"mu": mu, "nu": nu, "count": count}

    def fisher(state):
        return state["nu"]

    # meta lets make_optimizer rebuild this core as the fused step kernel
    return UpdateTransform(init=init, update=update, fisher=fisher,
                           tag="adamw_core",
                           meta={"kind": "adamw", "lr_fn": lr_fn, "b1": b1,
                                 "b2": b2, "eps": eps,
                                 "weight_decay": weight_decay})


def sgd_core(lr_fn, momentum: float = 0.0,
             fisher_decay: Optional[float] = None) -> UpdateTransform:
    """SGD with optional momentum; ``fisher_decay`` adds a g^2 EMA so
    LOTION has a Fisher estimate (the paper's synthetic experiments)."""

    def init(params):
        st = {"count": _count0(params)}
        if momentum:
            st["mu"] = tree_map(torch.zeros_like, params)
        if fisher_decay is not None:
            st["nu"] = tree_map(torch.zeros_like, params)
        return st

    def update(grads, state, params=None, **extras):
        count = state["count"] + 1
        lr = lr_fn(count)
        if extras.get("lr_scale") is not None:
            lr = lr * extras["lr_scale"]
        new_state = {"count": count}
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            new_state["mu"] = mu
            step_dir = mu
        else:
            step_dir = grads
        if fisher_decay is not None:
            new_state["nu"] = tree_map(
                lambda v, g: fisher_decay * v + (1 - fisher_decay) * g * g,
                state["nu"], grads)
        return tree_map(lambda g: -(lr * g), step_dir), new_state

    def fisher(state):
        return state.get("nu")

    return UpdateTransform(init=init, update=update, fisher=fisher,
                           tag="sgd_core",
                           meta={"kind": "sgd", "lr_fn": lr_fn,
                                 "momentum": momentum,
                                 "fisher_decay": fisher_decay})


def adamw(lr_fn, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    return _wrap(adamw_core(lr_fn, b1=b1, b2=b2, eps=eps,
                            weight_decay=weight_decay))


def sgd(lr_fn, momentum: float = 0.0, fisher_decay: Optional[float] = None
        ) -> Optimizer:
    return _wrap(sgd_core(lr_fn, momentum=momentum, fisher_decay=fisher_decay))
