"""Training-mode strategies (port of ``repro.core.modes``): one
``QuantConfig`` drives the whole stack.

* ``forward_params`` — the parameter transform applied before the model
  forward: the identity for fp32/ptq/lotion, the straight-through
  fake-quant of ``core/ste.py`` over the eligible leaves for qat (RTN)
  and rat (RR against explicit uniforms);
* ``penalty``     — the loss-side LOTION term
  ``lam * 1/2 sum f (hi-w)(w-lo)`` over the eligible leaves, through the
  ``lotion_reg`` kernel's autograd function (zero for every other method);
* ``cast_params`` — eval-time quantization of a parameter tree, RTN or RR,
  through the ``quant`` kernel (its plain version for CPU tensors).

There is no switch between kernels and plain paths: every kernel wrapper
launches its kernel for CUDA tensors and takes its plain version for CPU
tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from . import ste
from .formats import get_format
from .policy import QuantPolicy, path_str, tree_leaves, tree_map_multi

METHODS = ("fp32", "ptq", "qat", "rat", "lotion")
PENALTY_PLACEMENTS = ("loss", "decoupled")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    method: str = "fp32"
    fmt_name: str = "int4"
    block_size: int = -1          # -1 = per-tensor (paper's LLM setting)
    lam: float = 0.0              # LOTION lambda (paper sweeps 3e3..1e5)
    # "decoupled": closed-form penalty gradient applied once per step as an
    # optimizer-side transform; "loss": penalty added to the loss and
    # differentiated (DESIGN.md §2)
    penalty_placement: str = "decoupled"
    policy: QuantPolicy = dataclasses.field(default_factory=QuantPolicy)

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"method {self.method!r} not in {METHODS}")
        if self.penalty_placement not in PENALTY_PLACEMENTS:
            raise ValueError(f"penalty_placement {self.penalty_placement!r} "
                             f"not in {PENALTY_PLACEMENTS}")

    @property
    def fmt(self):
        return get_format(self.fmt_name)

    @property
    def is_noop(self) -> bool:
        return self.method in ("fp32", "ptq")


def leaf_uniforms(path, x, uniforms, generator, sharding=None
                  ) -> torch.Tensor:
    """The RR uniforms of one leaf: ``uniforms[path_str(path)]``, or a
    fresh draw in ``x``'s shape from ``generator`` on ``x``'s device.  For
    a block of a sharded leaf (``sharding``) the uniforms are the full
    leaf's, drawn or given whole, and the block's part of them is kept."""
    from ..distributed.sharding import global_shape, shard
    if uniforms is not None:
        return shard(uniforms[path_str(path)], sharding)
    return shard(torch.rand(global_shape(sharding, x.shape),
                            generator=generator, device=x.device,
                            dtype=x.dtype), sharding)


def map_eligible(policy: QuantPolicy, fn, params, shardings=None):
    """``fn(path, x, sharding)`` over the eligible leaves (identity
    elsewhere); with ``shardings`` the leaves are blocks, and eligibility
    is the full leaf's."""
    from ..distributed.sharding import full_view
    if shardings is None:
        return policy.map_eligible(lambda p, x: fn(p, x, None), params)
    return tree_map_multi(
        lambda p, x, s: fn(p, x, s) if policy.eligible(p, full_view(x, s))
        else x, params, shardings)


def forward_params(cfg: QuantConfig, params,
                   uniforms: Optional[Dict[str, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None,
                   shardings=None):
    """Parameter transform applied inside the loss (differentiable through
    the straight-through estimators).  ``rat`` takes its uniforms from
    ``uniforms`` (``{path_str: tensor}`` in each leaf's shape) or draws
    them from ``generator``, leaf by leaf in tree order; each leaf's draw
    is dropped once its cast is made, so at most one leaf's uniforms are
    alive.  With ``shardings`` the leaves are blocks: each casts with its
    whole matrices' absmax, and RAT's uniforms are the full leaf's (drawn
    in the one-device order), the block's part kept, so the casts are the
    blocks of the one-device casts."""
    from ..distributed.sharding import leaf_absmax
    if cfg.is_noop or cfg.method == "lotion":
        return params
    fmt, bs = cfg.fmt, cfg.block_size
    if cfg.method == "qat":
        return map_eligible(
            cfg.policy, lambda p, x, s: ste.fake_quant_rtn(
                x, fmt, bs, leaf_absmax(x, s, bs, path_str(p))),
            params, shardings)
    if cfg.method == "rat":
        if uniforms is None and generator is None:
            raise ValueError("RAT needs uniforms or a generator per step")
        return map_eligible(
            cfg.policy, lambda p, x, s: ste.fake_quant_rr(
                x, fmt, leaf_uniforms(p, x, uniforms, generator, s), bs,
                leaf_absmax(x, s, bs, path_str(p))), params, shardings)
    raise AssertionError(cfg.method)


def penalty(cfg: QuantConfig, params, fisher, shardings=None
            ) -> torch.Tensor:
    """LOTION regularizer summed over eligible params, scaled by lambda:
    one ``lotion_reg`` autograd call per eligible leaf, ``lam`` folded into
    each leaf's gradient (as the decoupled placement adds it).  With
    ``shardings`` the leaves are blocks: each takes its whole matrices'
    absmax, and the sum runs over every rank, each block counted once
    (its gradient on every replica)."""
    from ..distributed.sharding import (count_once, full_view, leaf_absmax,
                                        mesh_of, sum_all)
    from ..kernels.lotion_reg import lotion_penalty_fused
    dev = tree_leaves(params)[0].device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if cfg.method != "lotion" or cfg.lam == 0.0:
        return zero
    pens = []

    def visit(path, x, f, s=None):
        if cfg.policy.eligible(path, full_view(x, s)):
            pen = lotion_penalty_fused(
                x, f, cfg.fmt_name, cfg.block_size, cfg.lam,
                leaf_absmax(x, s, cfg.block_size, path_str(path)))
            pens.append(pen if s is None else count_once(pen, s))

    tree_map_multi(visit, params, fisher,
                   *(() if shardings is None else (shardings,)))
    total = torch.sum(torch.stack(pens)) if pens else zero
    if shardings is not None:
        total = sum_all(total, mesh_of(shardings))
    return total


def cast_params(params, fmt, policy: QuantPolicy, block_size: int = -1,
                mode: str = "rtn",
                uniforms: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
    """Eval/serve-time cast of the eligible leaves through the ``quant``
    kernel (one launch per eligible leaf).  ``mode="rr"`` takes its
    uniforms from ``uniforms`` (``{path_str: tensor}`` in each leaf's
    shape) or draws them from ``generator`` on the leaf's device, leaf by
    leaf in tree order."""
    from ..kernels.quant import quant_rr, quant_rtn
    fmt_name = fmt if isinstance(fmt, str) else fmt.name
    if mode == "rtn":
        return policy.map_eligible(
            lambda p, x: quant_rtn(x, fmt_name, block_size), params)
    if mode == "rr":
        if uniforms is None and generator is None:
            raise ValueError("RR cast needs uniforms or a generator")

        return policy.map_eligible(
            lambda p, x: quant_rr(x, leaf_uniforms(p, x, uniforms, generator),
                                  fmt_name, block_size), params)
    raise ValueError(f"mode {mode!r} not in ('rtn', 'rr')")
