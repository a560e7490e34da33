"""Fused clip + decoupled-LOTION + {AdamW, SGD} optimizer cores (port of
``repro.optim.fused``).

``fused_lotion_adamw_core`` collapses ``clip_global_norm ->
lotion_decoupled -> adamw_core`` into one terminal transform whose update
is one ``opt_step`` kernel launch per parameter leaf: one read of (w, g,
mu, nu) and one write of (w', mu', nu'), in place on the card.  The only
pre-pass left is the global-norm reduction.  ``applies_updates=True``: the
core returns the new parameters.  State is ``{"mu", "nu", "count",
"gnorm"[, "penalty"]}`` (``penalty`` only when ``lam != 0``).  All step
scalars (count, bias corrections, lr, clip scale, the skip flag) stay on
the device.  For CPU tensors the wrapper takes the kernel's plain version
(``kernels.opt_step.ref``), which returns new tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.policy import (QuantPolicy, tree_leaves, tree_map, tree_map_multi,
                           tree_map_with_path)
from ..kernels.opt_step import fused_opt_step_leaf
from .clip import clip_scale, global_norm
from .transform import UpdateTransform


def _fused_core(kind: str, lr_fn, *, b1: float, b2: float, eps: float,
                weight_decay: float, momentum: float, fisher_decay,
                fmt_name: str, lam: float, block_size: int,
                clip_norm: float, policy: Optional[QuantPolicy],
                meta: dict) -> UpdateTransform:
    policy = policy if policy is not None else QuantPolicy()

    def init(params):
        dev = tree_leaves(params)[0].device
        st = {"mu": tree_map(torch.zeros_like, params),
              "nu": tree_map(torch.zeros_like, params),
              "count": torch.zeros((), dtype=torch.int32, device=dev),
              "gnorm": torch.zeros((), dtype=torch.float32, device=dev)}
        # the "penalty" metric key exists only when this core owns a LOTION
        # term: under loss-side placement the penalty is the loss's
        if lam != 0.0:
            st["penalty"] = torch.zeros((), dtype=torch.float32, device=dev)
        return st

    def update(grads, state, params=None, **extras):
        if params is None:
            raise ValueError(f"fused_lotion_{kind}_core needs params")
        norm = global_norm(grads)
        # non-finite guard: a non-finite gnorm, or the train step's loss
        # flag, applies no update; the flag rides into the kernel as its
        # ok scalar and count/gnorm/penalty are held here
        ok = torch.isfinite(norm)
        step_ok = extras.get("step_ok")
        if step_ok is not None:
            ok = torch.logical_and(ok, step_ok)
        okf = ok.to(torch.float32)
        cscale = clip_scale(norm, clip_norm)
        count = state["count"] + 1
        if kind == "adamw":
            c = count.to(torch.float32)
            bc1 = 1 - b1 ** c
            bc2 = 1 - b2 ** c
        else:
            bc1 = bc2 = torch.ones_like(norm)
        lr = lr_fn(count)
        if extras.get("lr_scale") is not None:
            lr = lr * extras["lr_scale"]
        pens = []

        def leaf(path, g, w, m, n):
            leaf_lam = lam if (lam != 0.0 and policy.eligible(path, w)) else 0.0
            new_w, new_m, new_n, pen = fused_opt_step_leaf(
                w, g, m, n, lr=lr, bc1=bc1, bc2=bc2, clip_scale=cscale,
                lam=leaf_lam, fmt_name=fmt_name, block_size=block_size,
                b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                core=kind, momentum=momentum, fisher_decay=fisher_decay,
                ok=okf)
            if leaf_lam != 0.0:
                pens.append(pen.to(torch.float32))
            return (new_w, new_m, new_n)

        out = tree_map_multi(leaf, grads, params, state["mu"], state["nu"])
        new_state = {"mu": _pick(out, 1), "nu": _pick(out, 2),
                     "count": torch.where(ok, count, state["count"]),
                     "gnorm": torch.where(ok, norm, state["gnorm"])}
        if lam != 0.0:
            pen = (lam * torch.sum(torch.stack(pens)) if pens
                   else torch.zeros_like(norm))
            new_state["penalty"] = torch.where(ok, pen, state["penalty"])
        return _pick(out, 0), new_state

    def fisher(state):
        if kind == "sgd" and fisher_decay is None:
            return None               # nu is inert zeros, not a Fisher
        return state["nu"]

    return UpdateTransform(
        init=init, update=update, fisher=fisher,
        tag=f"fused_lotion_{kind}", applies_updates=True,
        meta={**meta, "lr_fn": lr_fn, "lam": lam, "fmt_name": fmt_name,
              "block_size": block_size, "clip_norm": clip_norm,
              "policy": policy})


def _pick(tree, i: int):
    """Element ``i`` of every (w, mu, nu) tuple leaf of a dict tree."""
    return tree_map_with_path(lambda p, leaf: leaf[i], tree)


def fused_lotion_adamw_core(lr_fn, b1: float = 0.9, b2: float = 0.95,
                            eps: float = 1e-8, weight_decay: float = 0.0,
                            *, fmt_name: str = "int4", lam: float = 0.0,
                            block_size: int = -1,
                            clip_norm: float = float("inf"),
                            policy: Optional[QuantPolicy] = None
                            ) -> UpdateTransform:
    """One-pass fused optimizer step (terminal core, applies updates);
    ``lam == 0`` is fused clip+AdamW with no bracket math."""
    return _fused_core(
        "adamw", lr_fn, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
        momentum=0.0, fisher_decay=None, fmt_name=fmt_name, lam=lam,
        block_size=block_size, clip_norm=clip_norm, policy=policy,
        meta={"kind": "fused_lotion_adamw", "b1": b1, "b2": b2, "eps": eps,
              "weight_decay": weight_decay})


def fused_lotion_sgd_core(lr_fn, momentum: float = 0.0,
                          fisher_decay: Optional[float] = None,
                          *, fmt_name: str = "int4", lam: float = 0.0,
                          block_size: int = -1,
                          clip_norm: float = float("inf"),
                          policy: Optional[QuantPolicy] = None
                          ) -> UpdateTransform:
    """One-pass fused clip + LOTION + SGD(+momentum) step; a LOTION term
    (``lam != 0``) needs ``fisher_decay`` (SGD has no second moment)."""
    if lam != 0.0 and fisher_decay is None:
        raise ValueError(
            "fused_lotion_sgd_core with lam != 0 needs fisher_decay: the "
            "LOTION penalty is Fisher-weighted and SGD tracks no second "
            "moment of its own")
    return _fused_core(
        "sgd", lr_fn, b1=0.0, b2=0.0, eps=0.0, weight_decay=0.0,
        momentum=momentum, fisher_decay=fisher_decay, fmt_name=fmt_name,
        lam=lam, block_size=block_size, clip_norm=clip_norm, policy=policy,
        meta={"kind": "fused_lotion_sgd", "momentum": momentum,
              "fisher_decay": fisher_decay})
