"""Shared-scale casts (the part of ``repro.core.quantize`` that the
serving packer needs): per-matrix (``block_size=-1``) or blockwise absmax
scales and the round-to-nearest cast, bit-identical to the JAX functions.

A quant block is a contiguous run of ``block_size`` elements along the
flattened tensor; ``block_size=-1`` takes one scale per matrix (the
trailing two axes, ``matrix_axes``), the paper's per-tensor scheme.
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


def cast_rtn(w: torch.Tensor, fmt, block_size: int = -1) -> torch.Tensor:
    """Round-to-nearest cast with shared absmax scales."""
    if block_size == -1:
        return fmt.rtn(w, fmt.scale(_absmax_pertensor(w)))
    blocked, shape, n_pad = _block_view(w, block_size)
    absmax = torch.amax(torch.abs(blocked), dim=-1, keepdim=True)
    return _unblock(fmt.rtn(blocked, fmt.scale(absmax)), shape, n_pad)
