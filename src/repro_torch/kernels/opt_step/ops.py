"""Wrapper of the ``opt_step`` CUDA kernel (``csrc/opt_step.cu``): one
fused clip + LOTION + AdamW/SGD step of one parameter leaf, in one launch
whatever the leaf's rank.

For CUDA tensors it launches the kernel or raises; the kernel writes w',
mu' and nu' IN PLACE over ``w``, ``mu`` and ``nu`` and the wrapper returns
those same tensors.  For CPU tensors it takes the plain version in
``ref.py``, which returns new tensors; callers use the returned tensors
either way.  ``fused_opt_step_leaf.launches`` counts the kernel's
launches (nothing else adds to it).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ...core.formats import CodebookFormat, get_format
from ...core.quantize import matrix_axes, matrix_scales
from .. import _build
from ...numerics import scalar
from .ref import opt_step_ref

_MODES = {"none": 0, "matrix": 1, "block": 2}
_CORES = {"adamw": 0, "sgd": 1}


def step_scalars(lr, bc1, bc2, clip_scale, ok, device) -> torch.Tensor:
    """The kernel's device operand ``[lr, bc1, bc2, clip, ok]`` (fp32);
    device tensors stay on the device, so a step makes no host sync."""
    return torch.stack([scalar(x, device)
                        for x in (lr, bc1, bc2, clip_scale, ok)])


def fused_opt_step_leaf(w, g, mu, nu, *, lr, bc1, bc2, clip_scale,
                        lam: float, fmt_name: str, block_size: int,
                        b1: float, b2: float, eps: float,
                        weight_decay: float, core: str = "adamw",
                        momentum: float = 0.0, fisher_decay=None,
                        ok=None) -> Tuple:
    """One fused (clip + LOTION + AdamW/SGD) step for one leaf.

    Returns ``(new_w, new_mu, new_nu, pen)``, ``pen`` the UNSCALED penalty
    (0 for ``lam == 0``).  ``lr``/``bc1``/``bc2``/``clip_scale``/``ok`` are
    floats or 0-d tensors; ``ok`` = 0 leaves w, mu, nu unchanged.
    ``core="sgd"`` uses ``momentum``/``fisher_decay`` and ignores b1, b2,
    eps, weight_decay and the bias corrections."""
    ok = 1.0 if ok is None else ok
    for name, t in (("g", g), ("mu", mu), ("nu", nu)):
        if t.shape != w.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must have w's shape "
                             f"{tuple(w.shape)}")
    if core not in _CORES:
        raise ValueError(f"core must be 'adamw' or 'sgd', got {core!r}")
    if lam != 0.0 and (block_size == 0 or block_size < -1):
        raise ValueError(f"block_size must be -1 or positive, got {block_size}")
    if w.device.type == "cpu":
        return opt_step_ref(w, g, mu, nu, lr=lr, bc1=bc1, bc2=bc2,
                            clip_scale=clip_scale, lam=lam, fmt_name=fmt_name,
                            block_size=block_size, b1=b1, b2=b2, eps=eps,
                            weight_decay=weight_decay, core=core,
                            momentum=momentum, fisher_decay=fisher_decay,
                            ok=ok)
    if w.device.type != "cuda":
        raise ValueError(f"opt_step runs on cuda or cpu, got {w.device}")
    _build.check_f32_cuda("opt_step", w, g, mu, nu)
    fmt = get_format(fmt_name)
    n = w.numel()
    sc = step_scalars(lr, bc1, bc2, clip_scale, ok, w.device)
    pen = torch.zeros((), dtype=torch.float32, device=w.device)
    mode = ("none" if lam == 0.0 else "matrix" if block_size == -1
            else "block")
    if n == 0:
        return w, mu, nu, pen
    scales = partials = None
    mat_numel = n
    if mode == "matrix":
        scales = matrix_scales(w, fmt)
        mat_numel = math.prod(w.shape[a] for a in matrix_axes(w))
    gx, gy = _build.grid_for(n, n // mat_numel)
    if mode != "none":
        partials = torch.empty(gx * gy, dtype=torch.float64, device=w.device)
    fd = 0.0 if fisher_decay is None else float(fisher_decay)
    with torch.no_grad():
        # in place: w', mu', nu' overwrite w, mu, nu in the kernel
        err = _build.lib().opt_step_launch(
            w.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
            sc.data_ptr(), None if scales is None else scales.data_ptr(),
            None if partials is None else partials.data_ptr(),
            pen.data_ptr() if mode != "none" else None, n, mat_numel,
            block_size, _MODES[mode], _CORES[core],
            int(isinstance(fmt, CodebookFormat)),
            int(fisher_decay is not None), int(bool(momentum)),
            # constants folded on the host in double, as JAX folds them
            b1, 1 - b1, b2, 1 - b2, eps, weight_decay, 0.5 * lam,
            momentum, fd, 1 - fd, float(fmt.qmax), gx, gy,
            torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(err, "opt_step")
    fused_opt_step_leaf.launches += 1
    return w, mu, nu, pen


fused_opt_step_leaf.launches = 0
