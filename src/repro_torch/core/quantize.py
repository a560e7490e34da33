"""Shared-scale quantization and casts (port of ``repro.core.quantize``),
bit-identical to the JAX functions on the CPU.

A quant block is a contiguous run of ``block_size`` elements along the
flattened tensor (the tail zero-padded); ``block_size=-1`` takes one scale
per matrix (the trailing two axes, ``matrix_axes``), the paper's
per-tensor scheme, so a stacked ``(L, a, b)`` leaf gets L scales.

Randomness enters as an explicit tensor: ``cast_rr`` takes the uniforms
(one per element of ``w``, in ``w``'s shape) instead of a key, so the
same numbers can be fed to the JAX function, the plain version and the
CUDA kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch


def matrix_axes(w: torch.Tensor) -> Tuple[int, ...]:
    """The axes of one 'tensor' for per-tensor scaling: the trailing 2
    for ndim >= 2 (one scale per matrix of a stacked tree), all for 1-D."""
    return tuple(range(max(w.ndim - 2, 0), w.ndim))


def _absmax_pertensor(w: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(w), dim=matrix_axes(w), keepdim=True)


def matrix_scales(w: torch.Tensor, fmt) -> torch.Tensor:
    """Per-matrix scales flattened to ``(n_matrices,)`` fp32: the scalar
    operand the per-tensor kernels read (one per matrix of a stacked
    leaf, found from each element's offset).  The absmax is the inf-norm,
    one reduction pass over ``w``: ``amax(abs(w))`` would first write and
    read back a full-size ``abs(w)`` (the max is exact either way)."""
    absmax = torch.linalg.vector_norm(w, ord=float("inf"),
                                      dim=matrix_axes(w), keepdim=True)
    return fmt.scale(absmax).reshape(-1).to(torch.float32)


def _block_view(w: torch.Tensor, block_size: int):
    """Reshape ``w`` into (n_blocks, block), zero-padding the tail."""
    shape = w.shape
    flat = w.reshape(-1)
    n = flat.shape[0]
    if block_size == -1 or block_size >= n:
        return flat.reshape(1, -1), shape, 0
    n_pad = (-n) % block_size
    if n_pad:
        flat = torch.nn.functional.pad(flat, (0, n_pad))
    return flat.reshape(-1, block_size), shape, n_pad


def _unblock(blocked: torch.Tensor, shape, n_pad: int) -> torch.Tensor:
    flat = blocked.reshape(-1)
    if n_pad:
        flat = flat[: flat.shape[0] - n_pad]
    return flat.reshape(shape)


def block_scales(w: torch.Tensor, fmt, block_size: int = -1) -> torch.Tensor:
    """Per-block scales, shape (n_blocks,) (blockwise) or per-matrix with
    keepdims (per-tensor)."""
    if block_size == -1:
        return fmt.scale(_absmax_pertensor(w))
    blocked, _, _ = _block_view(w, block_size)
    return fmt.scale(torch.amax(torch.abs(blocked), dim=-1))


def cast_rtn(w: torch.Tensor, fmt, block_size: int = -1) -> torch.Tensor:
    """Round-to-nearest cast with shared absmax scales."""
    if block_size == -1:
        return fmt.rtn(w, fmt.scale(_absmax_pertensor(w)))
    blocked, shape, n_pad = _block_view(w, block_size)
    absmax = torch.amax(torch.abs(blocked), dim=-1, keepdim=True)
    return _unblock(fmt.rtn(blocked, fmt.scale(absmax)), shape, n_pad)


def _rr(w, s, fmt, u):
    lo, hi = fmt.neighbors(w, s)
    gap = hi - lo
    # P(hi) in w-space; representable points (gap 0) stay at lo == hi
    p_hi = torch.where(gap > 0, (w - lo) / torch.where(gap > 0, gap, 1.0),
                       0.0)
    return torch.where(u < p_hi, hi, lo)


def cast_rr(w: torch.Tensor, fmt, uniforms: torch.Tensor,
            block_size: int = -1) -> torch.Tensor:
    """Unbiased randomized-rounding cast: each element goes to ``hi`` when
    its uniform ``u < (w - lo) / (hi - lo)`` and to ``lo`` otherwise, so
    E[cast_rr(w)] = w.  ``uniforms`` has ``w``'s shape."""
    if uniforms.shape != w.shape:
        raise ValueError(f"uniforms {tuple(uniforms.shape)} must have w's "
                         f"shape {tuple(w.shape)}")
    if block_size == -1:
        return _rr(w, fmt.scale(_absmax_pertensor(w)), fmt, uniforms)
    blocked, shape, n_pad = _block_view(w, block_size)
    ub, _, _ = _block_view(uniforms, block_size)
    absmax = torch.amax(torch.abs(blocked), dim=-1, keepdim=True)
    return _unblock(_rr(blocked, fmt.scale(absmax), fmt, ub), shape, n_pad)


def rr_neighbors(w: torch.Tensor, fmt, block_size: int = -1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Elementwise (lo, hi) representable brackets, in w's shape."""
    if block_size == -1:
        return fmt.neighbors(w, fmt.scale(_absmax_pertensor(w)))
    blocked, shape, n_pad = _block_view(w, block_size)
    absmax = torch.amax(torch.abs(blocked), dim=-1, keepdim=True)
    lo, hi = fmt.neighbors(blocked, fmt.scale(absmax))
    return _unblock(lo, shape, n_pad), _unblock(hi, shape, n_pad)


def rr_variance(w: torch.Tensor, fmt, block_size: int = -1) -> torch.Tensor:
    """Elementwise Var[eps] of unbiased RR: (hi - w)(w - lo)."""
    lo, hi = rr_neighbors(w, fmt, block_size)
    return (hi - w) * (w - lo)
