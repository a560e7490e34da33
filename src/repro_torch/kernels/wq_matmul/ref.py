"""Plain PyTorch version of the weight-quantized matmul (out-major layout).

The same arithmetic as ``repro.kernels.wq_matmul.ref``: unpack, dequantize
in fp32, contract in fp32, cast to x's dtype.  The CPU tests hold it to the
JAX oracle; ``chip_smoke.py`` holds the CUDA kernel to it on the card.
"""

from __future__ import annotations

import torch

# one nibble layout for weights and KV: even index in the low nibble
from ..decode_attn.ref import unpack_int4_ref


def dequant_t_ref(codes: torch.Tensor, scales: torch.Tensor, block_k: int,
                  int4: bool) -> torch.Tensor:
    """codes (..., N, K) int8 or (..., N, K//2) packed uint8; scales
    (..., N, K//bs) blockwise or (..., 1, 1) per-tensor -> fp32 (..., N, K)."""
    w = unpack_int4_ref(codes) if int4 else codes
    if block_k == -1:
        s = scales
    else:
        s = torch.repeat_interleave(scales, block_k, dim=-1)
    return w.to(torch.float32) * s


def wqt_matmul_ref(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                   block_k: int, int4: bool) -> torch.Tensor:
    """x (..., M, K) @ dequant_t(codes, scales)^T -> (..., M, N) in x.dtype."""
    w = dequant_t_ref(codes, scales, block_k, int4)
    return torch.matmul(x.to(torch.float32), w.transpose(-1, -2)).to(x.dtype)
