"""Wrappers of the ``lotion_reg`` CUDA kernel (``csrc/lotion_reg.cu``):
the Eq. 3 LOTION penalty of one leaf and its closed-form gradient in one
launch.

``lotion_penalty_fused_vg`` returns (value, grad): the decoupled,
optimizer-side entry point.  ``lotion_penalty_fused`` is the loss-side
entry point, a ``torch.autograd.Function``: its forward launches the kernel
and saves the gradient the kernel wrote, its backward returns ``g * grad``
for ``w`` and nothing for ``fisher`` (a constant), as the JAX custom VJP
does.  Both take ``lam`` (default 1, the JAX functions' case) and fold it
into the gradient as ``core.lotion.lotion_penalty_and_grad`` does, so the
loss-side and the decoupled placements add the same gradient bit for bit;
``lotion_penalty_fused`` then returns ``lam`` times the penalty.  For a
CUDA tensor they launch the kernel or raise; for a CPU tensor they take
the plain version in ``ref.py``.  ``lotion_penalty_fused_vg.launches``
counts the kernel's launches: one per call, and each call is exactly one
device kernel (the scales, the penalty's sum and every scratch slot are
the launch's own work; nothing is zeroed before it).

``plan`` is the launch's regime and work split (see ``Plan``), a function
of the shape, the co-resident count and the cluster limit alone, so the
penalty's summation order is fixed for a shape.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ...core.formats import CodebookFormat, get_format
from .. import _build
from ..quant import ops as quant_ops
from .ref import reg_ref

REGIMES = {"cluster": 0, "grid": 1, "block": 2}
# Blocks of the cluster regime's one cluster: the H100's largest
# (non-portable) cluster.
CLUSTER_MAX = 16
# Per-matrix leaves of at most this many elements take the cluster regime:
# where the two regimes cross on an NVIDIA H100 80GB HBM3 at 700 W
# (scripts/ablate_lotion_reg_torch.py): the cluster is faster at 12,000
# elements (10.3 us against 12.3), the grid at 81,920 (12.1 against 12.8),
# the two lines meet near 60,000.
CLUSTER_NUMEL = 64 * 1024
# ... and of at most this many matrices (the cluster walks them in turn,
# one cluster barrier each).
CLUSTER_MATS = 8
# Elements per block of the cluster regime, at least (a matrix of fewer
# than CLUSTER_MAX grains takes fewer blocks); 4096 and 8192 measured
# slower at (12000,).
CLUSTER_GRAIN = 2048


class Plan(NamedTuple):
    """How one launch covers a leaf.  ``regime``:

    * ``"grid"``: per-matrix scales, one cooperative launch of ``blocks``
      persistent blocks (at most the co-resident count) on
      ``kernels/quant/ops.py::plan``'s chunk walk (``chunk``, ``chunks``,
      ``scan_chunks``, the same meaning);
    * ``"cluster"``: per-matrix scales, one cluster of ``blocks`` blocks
      (at most the cluster limit) walking the matrices in turn, block r
      taking chunk r of ``chunk`` elements of each (``chunks`` = blocks);
      the absmax folds the maxima of the first ``scan_chunks`` blocks;
    * ``"block"``: blockwise scales, ``blocks`` blocks of one warp per
      quant block (a cooperative launch).

    ``sum_blocks``: the blocks' partials the penalty's sum adds, in block
    order (all of them)."""
    regime: str
    blocks: int
    chunk: int
    chunks: int
    scan_chunks: int
    sum_blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(n: int, mat_numel: int, block_size: int, co_resident: int,
         cluster_max: int = CLUSTER_MAX) -> Plan:
    """The plan for ``n`` elements in matrices of ``mat_numel``
    (``block_size = -1``) or in quant blocks of ``block_size``, with at
    most ``co_resident`` blocks on the card at once (the grid or block
    instance's) and clusters of at most ``cluster_max`` blocks.  An empty
    leaf is one block that writes a zero penalty."""
    if co_resident < 1:
        raise ValueError(f"co_resident must be positive, got {co_resident}")
    if not 1 <= cluster_max <= CLUSTER_MAX:
        raise ValueError(f"cluster_max must be in [1, {CLUSTER_MAX}], got "
                         f"{cluster_max}")
    if block_size > 0:
        g = quant_ops.block_grid(n, block_size, co_resident)
        return Plan("block", g, 0, 0, 0, g)
    if n == 0:
        return Plan("cluster", 1, quant_ops.VEC_STRIDE, 0, 0, 1)
    if n <= CLUSTER_NUMEL and n // mat_numel <= CLUSTER_MATS:
        per = _cdiv(_cdiv(mat_numel, min(cluster_max, _cdiv(
            mat_numel, CLUSTER_GRAIN))), quant_ops.VEC_STRIDE)
        chunk = quant_ops.VEC_STRIDE * per
        chunks = _cdiv(mat_numel, chunk)
        return Plan("cluster", chunks, chunk, chunks, chunks, chunks)
    q = quant_ops.plan(n, mat_numel, co_resident)
    return Plan("grid", q.blocks, q.chunk, q.chunks, q.scan_chunks, q.blocks)


def scratch_bytes(p: Plan, n_mats: int) -> int:
    """Device scratch of a launch (``lotion_reg_launch``'s layout): the
    blocks' double partials, then for the grid regime the run slots and
    the folded maxima (uint32)."""
    if p.regime == "cluster":
        return 0
    slots = n_mats * (min(p.blocks, p.scan_chunks) + 1) \
        if p.regime == "grid" else 0
    return 8 * p.blocks + 4 * slots


def launch_plan(w: torch.Tensor, fmt_name: str, block_size: int) -> Plan:
    """The plan of a ``lotion_penalty_fused_vg`` call on the CUDA tensor
    ``w``."""
    fp4 = int(isinstance(get_format(fmt_name), CodebookFormat))
    regime = "block" if block_size > 0 else "grid"
    co = _build.co_resident(w.device, "lotion_reg_blocks_per_sm",
                            REGIMES[regime], fp4)
    return plan(w.numel(), quant_ops.matrix_numel(w), block_size, co)


def lotion_penalty_fused_vg(w: torch.Tensor, fisher: torch.Tensor,
                            fmt_name: str = "int4", block_size: int = 256,
                            lam: float = 1.0,
                            absmax: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(penalty, grad) of one leaf in one launch, ``grad`` the closed-form
    a.e. derivative of ``lam`` times the penalty with a constant scale:
    the kernel for CUDA tensors, the plain version for CPU tensors.  The
    penalty is unscaled (no lam).  ``absmax`` ((n_matrices,) fp32,
    per-matrix scales only) gives each matrix's absmax: a sharded leaf's
    block takes its whole matrix's (the launch folds it into the block's
    own maxima)."""
    if fisher.shape != w.shape:
        raise ValueError(f"fisher {tuple(fisher.shape)} must have w's shape "
                         f"{tuple(w.shape)}")
    if block_size == 0 or block_size < -1:
        raise ValueError(f"block_size must be -1 or positive, got {block_size}")
    if absmax is not None and block_size != -1:
        raise ValueError("lotion_reg: a given absmax is for per-matrix "
                         f"scales, got block_size={block_size}")
    w, fisher = w.detach(), fisher.detach()
    if _build.plain(w):
        return reg_ref(w, fisher, fmt_name, block_size, lam, absmax)
    if w.device.type != "cuda":
        raise ValueError(f"lotion_reg runs on cuda or cpu, got {w.device}")
    _build.check_cuda_inputs("lotion_reg", w, fisher)
    fmt = get_format(fmt_name)
    n = w.numel()
    mat_numel = n if block_size > 0 else quant_ops.matrix_numel(w)
    p = launch_plan(w, fmt_name, block_size)
    grad = torch.empty_like(w)
    pen = torch.empty((), dtype=torch.float32, device=w.device)
    nbytes = scratch_bytes(p, n // mat_numel if mat_numel else 0)
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=w.device)
               if nbytes else None)
    given = (None if absmax is None or n == 0 else quant_ops.seeded_absmax(
        "lotion_reg", absmax, n // mat_numel, w.device))
    err = _build.lib().lotion_reg_launch(
        w.data_ptr(), fisher.data_ptr(), grad.data_ptr(),
        None if scratch is None else scratch.data_ptr(), pen.data_ptr(), n,
        mat_numel, p.chunk, p.chunks, p.scan_chunks, block_size,
        REGIMES[p.regime], int(isinstance(fmt, CodebookFormat)),
        # lam / 2 folded on the host in double, as core/lotion.py folds it
        float(fmt.qmax), 0.5 * lam, p.blocks, p.sum_blocks,
        None if given is None else given.data_ptr(),
        torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(err, "lotion_reg")
    lotion_penalty_fused_vg.launches += 1
    return pen, grad


lotion_penalty_fused_vg.launches = 0


class _FusedPenalty(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, fisher, fmt_name, block_size, lam, absmax):
        pen, grad = lotion_penalty_fused_vg(w, fisher, fmt_name, block_size,
                                            lam, absmax)
        ctx.save_for_backward(grad)
        return lam * pen

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g * grad, None, None, None, None, None


def lotion_penalty_fused(w, fisher, fmt_name: str = "int4",
                         block_size: int = 256,
                         lam: float = 1.0,
                         absmax: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """``lam`` times the penalty as a differentiable scalar; backward is
    ``g * grad`` from the same launch (no second pass over w), with
    ``lam`` already folded into ``grad``."""
    return _FusedPenalty.apply(w, fisher, fmt_name, block_size, lam, absmax)
