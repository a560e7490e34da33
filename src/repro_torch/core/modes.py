"""Training-mode strategies (port of ``repro.core.modes``): one
``QuantConfig`` drives the penalty and the eval casts.

* ``penalty``     — the loss-side LOTION term
  ``lam * 1/2 sum f (hi-w)(w-lo)`` over the eligible leaves, through the
  ``lotion_reg`` kernel's autograd function (zero for every other method);
* ``cast_params`` — eval-time quantization of a parameter tree, RTN or RR,
  through the ``quant`` kernel (its plain version for CPU tensors).

The ``qat`` and ``rat`` baselines need the straight-through estimators of
``core/ste.py``, which are not in this slice of the port.  There is no
switch between kernels and plain paths: every kernel wrapper launches its
kernel for CUDA tensors and takes its plain version for CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

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
        if self.method in ("qat", "rat"):
            raise NotImplementedError(
                f"method {self.method!r} needs the straight-through "
                f"estimators of core/ste.py, not ported yet: ROADMAP Queue 1 "
                f"item 2 (core/ste.py)")

    @property
    def fmt(self):
        return get_format(self.fmt_name)

    @property
    def is_noop(self) -> bool:
        return self.method in ("fp32", "ptq")


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

        def _rr(path, x):
            u = (uniforms[path_str(path)] if uniforms is not None else
                 torch.rand(x.shape, generator=generator, device=x.device,
                            dtype=x.dtype))
            return quant_rr(x, u, fmt_name, block_size)

        return policy.map_eligible(_rr, params)
    raise ValueError(f"mode {mode!r} not in ('rtn', 'rr')")
