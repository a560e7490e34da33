"""Wrapper of the ``opt_step`` CUDA kernel (``csrc/opt_step.cu``): one
fused clip + LOTION + AdamW/SGD step of one parameter leaf, in one launch
whatever the leaf's rank (with per-matrix scales one cooperative launch on
``kernels/quant/ops.py::plan``'s walk: the absmax phase, a grid barrier,
the step phase).

For CUDA tensors it launches the kernel or raises; the kernel writes w',
mu' and nu' IN PLACE over ``w``, ``mu`` and ``nu`` and the wrapper returns
those same tensors.  For CPU tensors it takes the plain version in
``ref.py`` (a large leaf a part at a time, ``_plain_in_parts``), which
returns new tensors; callers use the returned tensors either way.
``fused_opt_step_leaf.launches`` counts the kernel's launches (nothing
else adds to it).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...core.formats import CodebookFormat, get_format
from .. import _build
from ..quant import ops as quant_ops
from ...numerics import scalar
from .ref import opt_step_ref

_MODES = {"none": 0, "matrix": 1, "block": 2}
_CORES = {"adamw": 0, "sgd": 1}
# elements of one part of the plain version on the CPU (2 MB of fp32):
# the temporaries of a part stay in the caches; a whole 2048 x 2048
# matrix at a time took 1.7x as long on a shared 8-core host, a whole
# full-width leaf about 3x that
CPU_PART = 1 << 19
# elements of one part on fake tensors (a dry-run's trace: no data, and
# the fewer the ops the faster the trace)
FAKE_PART = 1 << 24


def step_scalars(lr, bc1, bc2, clip_scale, ok, device) -> torch.Tensor:
    """The kernel's device operand ``[lr, bc1, bc2, clip, ok]`` (fp32);
    device tensors stay on the device, so a step makes no host sync."""
    return torch.stack([scalar(x, device)
                        for x in (lr, bc1, bc2, clip_scale, ok)])


def _mode(lam: float, block_size: int) -> str:
    return "none" if lam == 0.0 else "matrix" if block_size == -1 else "block"


def _co_resident(w, mode: str, core: str, fp4: int, fisher_decay,
                 momentum) -> int:
    return _build.co_resident(
        w.device, "opt_step_blocks_per_sm", _CORES[core], _MODES[mode],
        fp4 if mode != "none" else 0, int(fisher_decay is not None),
        int(bool(momentum)))


def launch_plan(w: torch.Tensor, *, lam: float, fmt_name: str,
                core: str = "adamw", momentum: float = 0.0,
                fisher_decay=None) -> quant_ops.Plan:
    """The plan of a ``fused_opt_step_leaf`` call with per-matrix scales
    (or ``lam = 0``: mode none, the leaf one matrix) on the CUDA tensor
    ``w``."""
    mode = _mode(lam, -1)
    fp4 = int(isinstance(get_format(fmt_name), CodebookFormat))
    n = w.numel()
    return quant_ops.plan(
        n, quant_ops.matrix_numel(w) if mode == "matrix" else n,
        _co_resident(w, mode, core, fp4, fisher_decay, momentum))


def _plain_in_parts(w, g, mu, nu, mode: str, in_place: bool = False,
                    **kw) -> Tuple:
    """``opt_step_ref`` over parts of the leaf of at most about
    ``CPU_PART`` elements: with per-matrix scales, runs of rows of one
    matrix at a time, each given its matrix's absmax (taken first, in one
    pass over the leaf, unless ``kw`` gives it); in mode none runs of
    elements (blockwise scales take one call).  Every output element
    depends only on its own inputs and its matrix's scale, so w', mu' and
    nu' are those of one call, bit for bit; the penalty is the float64
    sum of the parts'.  ``in_place`` (a dry-run's fake tensors) writes
    each part into w, mu and nu, as the kernel does, in parts of
    ``FAKE_PART`` elements: the trace then holds the kernel's memory and
    few ops."""
    part = FAKE_PART if in_place else CPU_PART
    if mode == "none":
        parts = [t.reshape(-1) for t in (w, g, mu, nu)]
        cuts = [(slice(i, i + part),)
                for i in range(0, parts[0].shape[0], part)]
        given = [None] * len(cuts)
    elif mode == "matrix" and w.ndim >= 2:
        absmax = kw.pop("absmax", None)
        if absmax is None:
            absmax = torch.linalg.vector_norm(
                w, float("inf"), dim=(-2, -1)).reshape(-1)
        r, c = w.shape[-2:]
        parts = [t.reshape(-1, r, c) for t in (w, g, mu, nu)]
        cuts, given = [], []
        if in_place:       # whole matrices, as many as fit a part
            k = max(1, part // (r * c))
            for m in range(0, parts[0].shape[0], k):
                cuts.append((slice(m, m + k),))
                given.append(absmax[m:m + k])
        else:
            rows = max(1, part // c)
            for m in range(parts[0].shape[0]):
                for i in range(0, r, rows):
                    cuts.append((m, slice(i, i + rows)))
                    given.append(absmax[m:m + 1])
    else:
        return opt_step_ref(w, g, mu, nu, **kw)
    if len(cuts) == 1 and mode == "none" and not in_place:
        return opt_step_ref(w, g, mu, nu, **kw)
    outs = (parts[:1] + parts[2:] if in_place else
            [torch.empty_like(t) for t in parts[:1] + parts[2:]])
    pen = torch.zeros((), dtype=torch.float64, device=w.device)
    for cut, a in zip(cuts, given):
        got = opt_step_ref(*(t[cut] for t in parts), **kw,
                           **({} if a is None else {"absmax": a}))
        for o, x in zip(outs, got[:3]):
            o[cut] = x
        pen += got[3].to(torch.float64)
    if in_place:
        return w, mu, nu, pen.to(torch.float32)
    return tuple(o.reshape(w.shape) for o in outs) + (pen.to(torch.float32),)


def fused_opt_step_leaf(w, g, mu, nu, *, lr, bc1, bc2, clip_scale,
                        lam: float, fmt_name: str, block_size: int,
                        b1: float, b2: float, eps: float,
                        weight_decay: float, core: str = "adamw",
                        momentum: float = 0.0, fisher_decay=None,
                        ok=None, absmax=None) -> Tuple:
    """One fused (clip + LOTION + AdamW/SGD) step for one leaf.

    Returns ``(new_w, new_mu, new_nu, pen)``, ``pen`` the UNSCALED penalty
    (0 for ``lam == 0``).  ``lr``/``bc1``/``bc2``/``clip_scale``/``ok`` are
    floats or 0-d tensors; ``ok`` = 0 leaves w, mu, nu unchanged.
    ``core="sgd"`` uses ``momentum``/``fisher_decay`` and ignores b1, b2,
    eps, weight_decay and the bias corrections.  ``absmax``
    ((n_matrices,) fp32, per-matrix penalties only) gives each matrix's
    absmax: a sharded leaf's block steps with its whole matrix's."""
    ok = 1.0 if ok is None else ok
    if absmax is not None and _mode(lam, block_size) != "matrix":
        raise ValueError("opt_step: a given absmax is for per-matrix "
                         f"penalties, got lam={lam} block_size={block_size}")
    for name, t in (("g", g), ("mu", mu), ("nu", nu)):
        if t.shape != w.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must have w's shape "
                             f"{tuple(w.shape)}")
    if core not in _CORES:
        raise ValueError(f"core must be 'adamw' or 'sgd', got {core!r}")
    if lam != 0.0 and (block_size == 0 or block_size < -1):
        raise ValueError(f"block_size must be -1 or positive, got {block_size}")
    if _build.plain(w):
        return _plain_in_parts(w, g, mu, nu, _mode(lam, block_size),
                               in_place=_build.is_fake(w), lr=lr,
                               bc1=bc1, bc2=bc2, clip_scale=clip_scale,
                               lam=lam, fmt_name=fmt_name,
                               block_size=block_size, b1=b1, b2=b2, eps=eps,
                               weight_decay=weight_decay, core=core,
                               momentum=momentum, fisher_decay=fisher_decay,
                               ok=ok, absmax=absmax)
    if w.device.type != "cuda":
        raise ValueError(f"opt_step runs on cuda or cpu, got {w.device}")
    _build.check_cuda_inputs("opt_step", w, g, mu, nu)
    fmt = get_format(fmt_name)
    n = w.numel()
    sc = step_scalars(lr, bc1, bc2, clip_scale, ok, w.device)
    pen = torch.zeros((), dtype=torch.float32, device=w.device)
    mode = _mode(lam, block_size)
    if n == 0:
        return w, mu, nu, pen
    fp4 = int(isinstance(fmt, CodebookFormat))
    mat_numel = quant_ops.matrix_numel(w) if mode == "matrix" else n
    if mode == "block":
        p = quant_ops.Plan(quant_ops.block_grid(n, block_size, _co_resident(
            w, mode, core, fp4, fisher_decay, momentum)), 0, 0, 0)
    else:
        p = launch_plan(w, lam=lam, fmt_name=fmt_name, core=core,
                        momentum=momentum, fisher_decay=fisher_decay)
    amax = ticket = partials = None
    if mode != "none":
        # the per-matrix |w| bits (mode matrix; seeded with a given
        # absmax's) and the penalty's ticket
        zeros = torch.zeros(n // mat_numel + 1 if mode == "matrix" else 1,
                            dtype=torch.int32, device=w.device)
        if absmax is not None:
            zeros[:-1] = quant_ops.seeded_absmax("opt_step", absmax,
                                                 n // mat_numel, w.device)
        amax, ticket = zeros.data_ptr(), zeros[-1].data_ptr()
        partials = torch.empty(p.blocks, dtype=torch.float64, device=w.device)
    fd = 0.0 if fisher_decay is None else float(fisher_decay)
    with torch.no_grad():
        # in place: w', mu', nu' overwrite w, mu, nu in the kernel
        err = _build.lib().opt_step_launch(
            w.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
            sc.data_ptr(), amax if mode == "matrix" else None,
            None if partials is None else partials.data_ptr(), ticket,
            pen.data_ptr() if mode != "none" else None, n, mat_numel,
            p.chunk, p.chunks, p.scan_chunks, block_size, _MODES[mode],
            _CORES[core], fp4, int(fisher_decay is not None),
            int(bool(momentum)),
            # constants folded on the host in double, as JAX folds them
            b1, 1 - b1, b2, 1 - b2, eps, weight_decay, 0.5 * lam,
            momentum, fd, 1 - fd, float(fmt.qmax), p.blocks,
            torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(err, "opt_step")
    fused_opt_step_leaf.launches += 1
    return w, mu, nu, pen


fused_opt_step_leaf.launches = 0
