"""Plain PyTorch versions of the weight-quantized matmuls.

The same arithmetic as ``repro.kernels.wq_matmul.ref``: the out-major
``wqt_matmul`` (unpack, dequantize in fp32, contract in fp32, cast to x's
dtype), its integer-activation twin ``wqt_matmul_a8`` (int8 codes
contracted exactly, the scales in an fp32 epilogue) with
``wqt_matmul_a8_x`` (the row quantizer in front, the cast behind) and the
K-major ``wq_matmul``, with the quantizers that feed them.  The CPU tests hold
them to the JAX oracles; ``chip_smoke.py`` holds the CUDA kernels to them
on the card.
"""

from __future__ import annotations

import torch

from ...numerics import div_scalar
# one nibble layout for weights and KV: even index in the low nibble
from ..decode_attn.ref import unpack_int4_ref


def _pack_last(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes (..., C), C even -> packed uint8 (..., C//2), even index
    in the low nibble: the one packing of QTensor weights, K-major weights
    and the int4 KV cache."""
    lo = codes[..., 0::2].to(torch.int32) & 0xF
    hi = codes[..., 1::2].to(torch.int32) & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


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


# --------------------------------------------------------------------------
# W4A8 / W8A8 (integer activations) and the K-major layout
# --------------------------------------------------------------------------

def _int_dot(a: torch.Tensor, b: torch.Tensor, eq: str) -> torch.Tensor:
    """Integer contraction of int8 codes, returned as int32.  Torch has no
    int32 matmul on CUDA, so it runs in float64: every product and partial
    sum is an integer below 2^53 (|acc| <= 127 * 127 * K), so the result
    is exact in any summation order."""
    return torch.einsum(eq, a.to(torch.float64),
                        b.to(torch.float64)).to(torch.int32)


def quantize_acts_ref(x: torch.Tensor):
    """Per-row symmetric int8 activation quantization, the A8 half of
    W4A8 serving: x (..., M, K) -> (codes int8, scale fp32 (..., M, 1));
    a zero row gets scale 1.  ``torch.round`` rounds half to even, as
    ``jnp.rint`` does; the divisions are IEEE on every device."""
    xf = x.to(torch.float32)
    absmax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, div_scalar(absmax, 127.0),
                        torch.ones_like(absmax))
    codes = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return codes, scale


def wqt_matmul_a8_ref(xq: torch.Tensor, xs: torch.Tensor, codes: torch.Tensor,
                      scales: torch.Tensor, block_k: int,
                      int4: bool) -> torch.Tensor:
    """xq (..., M, K) int8 activation codes with fp32 row scales xs
    (..., M, 1), against out-major int8 / packed int4 codes -> fp32
    (..., M, N).  Per tensor: ``(float(acc) * xs) * s`` with acc the int32
    sum over all of K.  Blockwise: ``sum_b float(acc_b) * s_b`` folded in
    block order (a rounding per product and per sum), then ``* xs``; the
    CUDA kernel repeats both orders, so the two agree bit for bit."""
    w = unpack_int4_ref(codes) if int4 else codes
    if block_k == -1:
        acc = _int_dot(xq, w, "...mk,...nk->...mn")
        return acc.to(torch.float32) * xs * scales
    kb = scales.shape[-1]
    xb = xq.reshape(xq.shape[:-1] + (kb, block_k))
    wb = w.reshape(w.shape[:-1] + (kb, block_k))
    acc = _int_dot(xb, wb, "...mbk,...nbk->...mnb").to(torch.float32)
    out = acc[..., 0] * scales[..., 0].unsqueeze(-2)
    for b in range(1, kb):
        out = out + acc[..., b] * scales[..., b].unsqueeze(-2)
    return out * xs


def wqt_matmul_a8_x_ref(x: torch.Tensor, codes: torch.Tensor,
                        scales: torch.Tensor, block_k: int,
                        int4: bool) -> torch.Tensor:
    """W4A8 / W8A8 from the activations, as the JAX package's
    ``core/qtensor.py::matmul`` composes it under ``act_fmt="int8"``:
    ``quantize_acts_ref``, then ``wqt_matmul_a8_ref``, then the cast to
    x's dtype."""
    xq, xs = quantize_acts_ref(x)
    return wqt_matmul_a8_ref(xq, xs, codes, scales, block_k,
                             int4).to(x.dtype)


def dequant_ref(codes: torch.Tensor, scales: torch.Tensor, block_k: int,
                int4: bool) -> torch.Tensor:
    """K-major layout: codes (K, N) int8 or (K//2, N) packed uint8 (even k
    of a pair in the low nibble); scales (K//bs, N) -> fp32 (K, N)."""
    w = unpack_int4_ref(codes.T).T if int4 else codes
    s = torch.repeat_interleave(scales, block_k, dim=0)
    return w.to(torch.float32) * s


def wq_matmul_ref(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                  block_k: int, int4: bool) -> torch.Tensor:
    """x (M, K) @ dequant(codes, scales) (K-major) -> (M, N) in x.dtype."""
    w = dequant_ref(codes, scales, block_k, int4)
    return (x.to(torch.float32) @ w).to(x.dtype)


def quantize_weights_ref(w: torch.Tensor, block_k: int, bits: int):
    """Blockwise (along K) symmetric quantization of a (K, N) weight into
    the K-major layout: (codes, scales (K//bs, N) fp32), codes packed two
    k per byte for int4."""
    K, N = w.shape
    qmax = 2 ** (bits - 1) - 1
    wb = w.reshape(K // block_k, block_k, N)
    absmax = torch.amax(torch.abs(wb), dim=1)
    scales = torch.where(absmax > 0, div_scalar(absmax, float(qmax)),
                         torch.ones_like(absmax))
    codes = torch.clamp(torch.round(wb / scales[:, None, :]), -qmax, qmax)
    codes = codes.reshape(K, N).to(torch.int8)
    if bits == 4:
        return (_pack_last(codes.T).T.contiguous(),
                scales.to(torch.float32))
    return codes, scales.to(torch.float32)
