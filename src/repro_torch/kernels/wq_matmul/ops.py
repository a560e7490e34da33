"""Wrappers of the weight-quantized matmul CUDA kernels (``csrc/``):
``wqt_matmul`` (out-major codes) and ``wq_matmul`` (K-major codes), two
instances of ``wqt_matmul.cu``, and ``wqt_matmul_a8`` (int8 activation
codes against out-major codes, ``wqt_matmul_a8.cu``).

For a CUDA tensor each launches its kernel or raises; for a CPU tensor it
takes the plain version in ``ref.py``.  Each wrapper's ``.launches`` counts
its kernel's launches (nothing else adds to it).
"""

from __future__ import annotations

import torch

from .ref import (quantize_weights_ref, wq_matmul_ref, wqt_matmul_a8_ref,
                  wqt_matmul_ref)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x, codes, scales, block_k: int, bits: int):
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if x.ndim != 2 or codes.ndim != 2:
        raise ValueError(f"x and codes must be 2-D, got {tuple(x.shape)} and "
                         f"{tuple(codes.shape)}")
    M, K = x.shape
    N = codes.shape[0]
    if bits == 4:
        if K % 2:
            raise ValueError(f"int4 codes need even K, got {K}")
        if codes.dtype != torch.uint8 or codes.shape[1] != K // 2:
            raise ValueError(f"int4 codes must be uint8 ({N}, {K // 2}), got "
                             f"{codes.dtype} {tuple(codes.shape)}")
    elif codes.dtype != torch.int8 or codes.shape[1] != K:
        raise ValueError(f"int8 codes must be int8 ({N}, {K}), got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    if block_k == -1:
        if tuple(scales.shape[-2:]) != (1, 1) or scales.numel() != 1:
            raise ValueError(f"per-tensor scales must be (1, 1), got "
                             f"{tuple(scales.shape)}")
    else:
        if block_k <= 0 or K % block_k:
            raise ValueError(f"K={K} not divisible by block_k={block_k}")
        if tuple(scales.shape) != (N, K // block_k):
            raise ValueError(f"blockwise scales must be {(N, K // block_k)}, "
                             f"got {tuple(scales.shape)}")
    if scales.dtype != torch.float32:
        raise ValueError(f"scales must be float32, got {scales.dtype}")
    return M, N, K


def _check_cuda(name: str, **tensors) -> torch.device:
    """Raise unless every tensor is contiguous on the first one's CUDA
    device; returns that device."""
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, got {dev}")
    for tname, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    return dev


def _vec_ok(codes: torch.Tensor, row_bytes: int) -> int:
    return int(row_bytes % 16 == 0 and codes.data_ptr() % 16 == 0)


def wqt_matmul(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
               block_k: int = -1, bits: int = 8) -> torch.Tensor:
    """x (M, K) @ dequant(codes (N, K[/2]), scales)^T -> (M, N) in x.dtype.

    ``block_k=-1``: one (1, 1) scale per matrix; otherwise (N, K//block_k)
    blockwise scales along K.  int4 codes are packed two per byte, the even
    k in the low nibble."""
    M, N, K = _check(x, codes, scales, block_k, bits)
    if x.device.type == "cpu":
        return wqt_matmul_ref(x, codes, scales, block_k, bits == 4)
    _check_cuda("wqt_matmul", x=x, codes=codes, scales=scales)
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    from repro_torch.kernels import _build
    lib = _build.lib()
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    splits = lib.wqt_matmul_splits(M, N, K)
    # fp32 partial tiles of the K splits (kept alive through the launch)
    work = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.wqt_matmul_launch(x.data_ptr(), codes.data_ptr(),
                                scales.data_ptr(), out.data_ptr(),
                                work.data_ptr() if work is not None else None,
                                M, N, K, block_k, bits, _DTYPES[x.dtype],
                                _vec_ok(codes, codes.shape[1]), stream)
    _build.check(err, "wqt_matmul")
    wqt_matmul.launches += 1
    return out


wqt_matmul.launches = 0


def wqt_matmul_a8(xq: torch.Tensor, xs: torch.Tensor, codes: torch.Tensor,
                  scales: torch.Tensor, block_k: int = -1,
                  bits: int = 8) -> torch.Tensor:
    """W4A8 / W8A8: int8 activation codes xq (M, K) with fp32 row scales
    xs (M, 1) against out-major codes (N, K[/2]) -> fp32 (M, N).  The
    contraction is exact in int32 and both scales fold into an fp32
    epilogue (``wqt_matmul_a8_ref``'s order).  The kernel takes blockwise
    scales with ``block_k`` a multiple of 4."""
    M, N, K = _check(xq, codes, scales, block_k, bits)
    if xq.dtype != torch.int8:
        raise ValueError(f"xq must be int8 codes, got {xq.dtype}")
    if tuple(xs.shape) != (M, 1) or xs.dtype != torch.float32:
        raise ValueError(f"xs must be float32 ({M}, 1), got {xs.dtype} "
                         f"{tuple(xs.shape)}")
    if xq.device.type == "cpu":
        return wqt_matmul_a8_ref(xq, xs, codes, scales, block_k, bits == 4)
    _check_cuda("wqt_matmul_a8", xq=xq, xs=xs, codes=codes, scales=scales)
    if block_k != -1 and block_k % 4:
        raise ValueError(f"the wqt_matmul_a8 kernel takes block_k = -1 or a "
                         f"multiple of 4 (four int8 codes per __dp4a word), "
                         f"got {block_k}")
    from repro_torch.kernels import _build
    lib = _build.lib()
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    if M == 0 or N == 0:
        return out
    segs = lib.wqt_matmul_a8_segments(M, N, K, block_k)
    # int32 partial sums of the K segments (kept alive through the launch)
    work = (torch.empty((segs, M, N), dtype=torch.int32, device=xq.device)
            if segs > 0 else None)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    err = lib.wqt_matmul_a8_launch(
        xq.data_ptr(), xs.data_ptr(), codes.data_ptr(), scales.data_ptr(),
        out.data_ptr(), work.data_ptr() if work is not None else None,
        M, N, K, block_k, bits, _vec_ok(codes, codes.shape[1]), stream)
    _build.check(err, "wqt_matmul_a8")
    wqt_matmul_a8.launches += 1
    return out


wqt_matmul_a8.launches = 0


def pack_weight(w: torch.Tensor, block_k: int = 128, bits: int = 4):
    """(K, N) fp -> (codes, scales) in the K-major ``wq_matmul`` layout."""
    return quantize_weights_ref(w, block_k, bits)


def wq_matmul(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
              block_k: int = 128, bits: int = 4) -> torch.Tensor:
    """x (M, K) @ dequant(codes, scales) with K-major codes: int8 (K, N)
    or packed uint8 (K//2, N) (even k in the low nibble), scales
    (K//block_k, N) -> (M, N) in x.dtype."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if x.ndim != 2 or codes.ndim != 2:
        raise ValueError(f"x and codes must be 2-D, got {tuple(x.shape)} and "
                         f"{tuple(codes.shape)}")
    M, K = x.shape
    N = codes.shape[1]
    rows, cdtype = (K // 2, torch.uint8) if bits == 4 else (K, torch.int8)
    if (bits == 4 and K % 2) or codes.shape[0] != rows or \
            codes.dtype != cdtype:
        raise ValueError(f"int{bits} K-major codes must be {cdtype} "
                         f"({rows}, {N}) for K={K}, got {codes.dtype} "
                         f"{tuple(codes.shape)}")
    if block_k <= 0 or K % block_k:
        raise ValueError(f"K={K} not divisible by block_k={block_k}")
    if tuple(scales.shape) != (K // block_k, N) or \
            scales.dtype != torch.float32:
        raise ValueError(f"scales must be float32 {(K // block_k, N)}, got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if x.device.type == "cpu":
        return wq_matmul_ref(x, codes, scales, block_k, bits == 4)
    _check_cuda("wq_matmul", x=x, codes=codes, scales=scales)
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    from repro_torch.kernels import _build
    lib = _build.lib()
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    splits = lib.wqt_matmul_splits(M, N, K)
    work = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.wq_matmul_launch(x.data_ptr(), codes.data_ptr(),
                               scales.data_ptr(), out.data_ptr(),
                               work.data_ptr() if work is not None else None,
                               M, N, K, block_k, bits, _DTYPES[x.dtype],
                               _vec_ok(codes, N), stream)
    _build.check(err, "wq_matmul")
    wq_matmul.launches += 1
    return out


wq_matmul.launches = 0
