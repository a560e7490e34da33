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


def leaf_uniforms(path, x, uniforms, generator) -> torch.Tensor:
    """The RR uniforms of one leaf: ``uniforms[path_str(path)]``, or a
    fresh draw in ``x``'s shape from ``generator`` on ``x``'s device."""
    if uniforms is not None:
        return uniforms[path_str(path)]
    return torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype)


def forward_params(cfg: QuantConfig, params,
                   uniforms: Optional[Dict[str, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None):
    """Parameter transform applied inside the loss (differentiable through
    the straight-through estimators).  ``rat`` takes its uniforms from
    ``uniforms`` (``{path_str: tensor}`` in each leaf's shape) or draws
    them from ``generator``, leaf by leaf in tree order; each leaf's draw
    is dropped once its cast is made, so at most one leaf's uniforms are
    alive."""
    if cfg.is_noop or cfg.method == "lotion":
        return params
    fmt, bs = cfg.fmt, cfg.block_size
    if cfg.method == "qat":
        return cfg.policy.map_eligible(
            lambda p, x: ste.fake_quant_rtn(x, fmt, bs), params)
    if cfg.method == "rat":
        if uniforms is None and generator is None:
            raise ValueError("RAT needs uniforms or a generator per step")
        return cfg.policy.map_eligible(
            lambda p, x: ste.fake_quant_rr(
                x, fmt, leaf_uniforms(p, x, uniforms, generator), bs), params)
    raise AssertionError(cfg.method)


def penalty(cfg: QuantConfig, params, fisher) -> torch.Tensor:
    """LOTION regularizer summed over eligible params, scaled by lambda:
    one ``lotion_reg`` autograd call per eligible leaf, ``lam`` folded into
    each leaf's gradient (as the decoupled placement adds it)."""
    from ..kernels.lotion_reg import lotion_penalty_fused
    dev = tree_leaves(params)[0].device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if cfg.method != "lotion" or cfg.lam == 0.0:
        return zero
    pens = []

    def visit(path, x, f):
        if cfg.policy.eligible(path, x):
            pens.append(lotion_penalty_fused(x, f, cfg.fmt_name,
                                             cfg.block_size, cfg.lam))

    tree_map_multi(visit, params, fisher)
    if not pens:
        return zero
    return torch.sum(torch.stack(pens))


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
