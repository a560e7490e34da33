"""Wrappers of the ``quant`` CUDA kernel (``csrc/quant.cu``): the fused
absmax scale + RTN or RR + dequantize cast of a tensor of any rank, fp32
in and out; ``quant_rtn`` also takes a bf16 tensor (the fake-quantized
activations of ``LMConfig.act_fmt``) with per-matrix scales on an INT
grid, which runs the kernel's bf16 instance, bf16 in and out, rounding as
the plain version does on a bf16 tensor.

For a CUDA tensor they launch the kernel or raise; for a CPU tensor they
take the plain version in ``ref.py``.  ``quant_rtn.launches`` and
``quant_rr.launches`` count the kernel's launches (nothing else adds to
them).  Scales follow ``core/quantize.py``: one per matrix of a stacked
leaf for ``block_size=-1``, else contiguous blocks of the flattened tensor.

``plan`` is the work split of the per-matrix launches of ``quant.cu`` and
``opt_step.cu`` (one persistent, cooperative kernel: the absmax phase, a
grid barrier, the cast or step phase); ``chunk_range`` and
``block_chunks`` are the kernels' chunk walk in Python.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ...core.formats import CodebookFormat, get_format
from ...core.quantize import matrix_axes
from .. import _build
from .ref import rr_ref, rtn_ref

VEC_STRIDE = 1024  # elements: one 16-byte vector per thread of a block
TILE = 8192        # elements: one step of the absmax phase (8 vectors)


class Plan(NamedTuple):
    """How a per-matrix launch walks a leaf of matrices of ``mat_numel``
    elements: ``blocks`` persistent blocks (at most the co-resident
    count), each matrix cut into ``chunks`` chunks of ``chunk`` elements
    (its last one shorter); chunk c is chunk c % chunks of matrix c //
    chunks, and block b takes chunks b, b + blocks, ...  The absmax phase
    walks the first ``scan_chunks`` chunks of each matrix the same way:
    all of them."""
    blocks: int
    chunk: int
    chunks: int
    scan_chunks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(n: int, mat_numel: int, co_resident: int) -> Plan:
    """The plan for ``n`` elements in matrices of ``mat_numel`` with at
    most ``co_resident`` blocks on the card at once (the cooperative
    launch's limit).  Chunks of one tile: no block walks more than one
    chunk beyond the flat split of the tiles, and at any time the blocks
    stream one window of consecutive chunks (larger chunks, each block on
    its own region, measured slower: scripts/ablate_quant_opt_torch.py,
    variant ``big``).  A leaf of fewer
    tiles than co-resident blocks is cut finer, down to one vector a
    thread, so that more blocks share its DRAM round trips."""
    if co_resident < 1:
        raise ValueError(f"co_resident must be positive, got {co_resident}")
    n_mats = n // mat_numel if mat_numel else 0
    if n_mats == 0:
        return Plan(0, TILE, 0, 0)
    chunk = TILE
    if n_mats * _cdiv(mat_numel, TILE) < co_resident:
        per_mat = max(1, co_resident // n_mats)
        chunk = VEC_STRIDE * _cdiv(_cdiv(mat_numel, per_mat), VEC_STRIDE)
    chunks = _cdiv(mat_numel, chunk)
    return Plan(min(co_resident, n_mats * chunks), chunk, chunks, chunks)


def chunk_range(p: Plan, mat_numel: int, c: int,
                per_mat: int) -> Tuple[int, int]:
    """Element range [s, e) of chunk c of a walk with ``per_mat`` chunks
    per matrix, as ``qm::chunk_range`` cuts it."""
    m, j = divmod(c, per_mat)
    s = m * mat_numel + j * p.chunk
    return s, min(s + p.chunk, (m + 1) * mat_numel)


def block_chunks(p: Plan, n_mats: int, b: int, per_mat: int) -> range:
    """The chunks block b walks in a walk with ``per_mat`` chunks per
    matrix (``qm::ChunkIter``, forward)."""
    return range(b, n_mats * per_mat, p.blocks)


def matrix_numel(w: torch.Tensor) -> int:
    """Elements of one matrix of ``w`` under per-matrix scales."""
    return math.prod(w.shape[a] for a in matrix_axes(w))


def block_grid(n: int, block_size: int, co_resident: int) -> int:
    """Blocks of a blockwise launch: one warp per quant block, at most the
    co-resident count."""
    warps = _build.THREADS // 32
    return max(1, min(co_resident, _cdiv(_cdiv(n, block_size), warps)))


def _co_resident(w: torch.Tensor, blockwise: bool, fp4: int, rr: bool) -> int:
    return _build.co_resident(w.device, "quant_blocks_per_sm",
                              int(blockwise), fp4, int(rr),
                              int(w.dtype == torch.bfloat16))


def launch_plan(w: torch.Tensor, fmt_name: str, rr: bool = False) -> Plan:
    """The plan of a per-matrix ``quant_rtn`` (``rr``: ``quant_rr``) call
    on the CUDA tensor ``w``."""
    fp4 = int(isinstance(get_format(fmt_name), CodebookFormat))
    return plan(w.numel(), matrix_numel(w), _co_resident(w, False, fp4, rr))


def seeded_absmax(name: str, absmax: torch.Tensor, n_mats: int,
                  device) -> torch.Tensor:
    """The per-matrix |w| bits buffer of a per-matrix launch seeded with a
    given absmax ((n_mats,) fp32, each matrix's largest |w| over the
    whole matrix, at least the block's own): the kernel's absmax phase
    folds the block's maxima into it by atomicMax, which leaves the given
    value."""
    if tuple(absmax.shape) != (n_mats,) or absmax.dtype != torch.float32:
        raise ValueError(f"{name}: absmax must be ({n_mats},) float32, got "
                         f"{tuple(absmax.shape)} {absmax.dtype}")
    if absmax.device != device:
        raise ValueError(f"{name}: absmax on {absmax.device}, w on {device}")
    return absmax.contiguous().view(torch.int32).clone()


def _check_bf16(name: str, rr: bool, fmt, block_size: int) -> None:
    """The bf16 instance is the per-matrix RTN cast on an INT grid."""
    if rr or block_size != -1 or isinstance(fmt, CodebookFormat):
        raise ValueError(
            f"{name}: bf16 input takes the per-matrix RTN cast on an INT "
            f"grid (block_size=-1), got rr={rr}, block_size={block_size}, "
            f"fmt={fmt.name}")


def _launch(name: str, w: torch.Tensor, u: Optional[torch.Tensor],
            fmt_name: str, block_size: int,
            absmax: Optional[torch.Tensor] = None) -> torch.Tensor:
    if w.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, got {w.device}")
    if block_size == 0 or block_size < -1:
        raise ValueError(f"block_size must be -1 or positive, got {block_size}")
    fmt = get_format(fmt_name)
    bf16 = w.dtype == torch.bfloat16
    if absmax is not None and (block_size != -1 or bf16):
        raise ValueError(f"{name}: a given absmax is for per-matrix fp32 "
                         f"casts, got block_size={block_size} {w.dtype}")
    if bf16:
        _check_bf16(name, u is not None, fmt, block_size)
        _build.check_cuda_inputs(name, w, dtype=torch.bfloat16)
    else:
        _build.check_cuda_inputs(name, w, *(() if u is None else (u,)))
    out = torch.empty_like(w)
    n = w.numel()
    if n == 0:
        return out
    fp4 = int(isinstance(fmt, CodebookFormat))
    amax = None
    if block_size > 0:
        mat_numel, p = n, Plan(block_grid(
            n, block_size, _co_resident(w, True, fp4, u is not None)),
            0, 0, 0)
    else:
        mat_numel, p = matrix_numel(w), launch_plan(w, fmt_name, u is not None)
        amax = (torch.zeros(n // mat_numel, dtype=torch.int32, device=w.device)
                if absmax is None else
                seeded_absmax(name, absmax, n // mat_numel, w.device))
    err = _build.lib().quant_launch(
        w.data_ptr(), None if u is None else u.data_ptr(), out.data_ptr(),
        None if amax is None else amax.data_ptr(), n, mat_numel, p.chunk,
        p.chunks, p.scan_chunks, block_size, fp4, float(fmt.qmax), p.blocks,
        int(bf16), torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(err, name)
    return out


def quant_rtn(w: torch.Tensor, fmt_name: str = "int4",
              block_size: int = 256,
              absmax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Round-to-nearest cast of ``w`` (any rank), dequantized, in ``w``'s
    dtype (fp32, or bf16 for the per-matrix INT cast).  ``absmax``
    ((n_matrices,) fp32, per-matrix scales only) gives each matrix's
    absmax: a sharded leaf's block casts with its whole matrix's."""
    if _build.plain(w):
        return rtn_ref(w, fmt_name, block_size, absmax)
    out = _launch("quant_rtn", w, None, fmt_name, block_size, absmax)
    quant_rtn.launches += 1
    return out


def quant_rr(w: torch.Tensor, uniforms: torch.Tensor, fmt_name: str = "int4",
             block_size: int = 256,
             absmax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Randomized-rounding cast of ``w`` against ``uniforms`` (``w``'s
    shape, in [0, 1)): up where ``u < (w - lo) / (hi - lo)``; ``absmax``
    as for :func:`quant_rtn`."""
    if uniforms.shape != w.shape:
        raise ValueError(f"uniforms {tuple(uniforms.shape)} must have w's "
                         f"shape {tuple(w.shape)}")
    if _build.plain(w):
        return rr_ref(w, uniforms, fmt_name, block_size, absmax)
    out = _launch("quant_rr", w, uniforms, fmt_name, block_size, absmax)
    quant_rr.launches += 1
    return out


quant_rtn.launches = 0
quant_rr.launches = 0
