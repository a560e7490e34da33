"""Wrapper of the ``wqt_matmul`` CUDA kernel (``csrc/wqt_matmul.cu``).

For a CUDA tensor it launches the kernel or raises; for a CPU tensor it
takes the plain version in ``ref.py``.  ``wqt_matmul.launches`` counts the
kernel's launches (nothing else adds to it).
"""

from __future__ import annotations

import torch

from .ref import wqt_matmul_ref

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


def wqt_matmul(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
               block_k: int = -1, bits: int = 8) -> torch.Tensor:
    """x (M, K) @ dequant(codes (N, K[/2]), scales)^T -> (M, N) in x.dtype.

    ``block_k=-1``: one (1, 1) scale per matrix; otherwise (N, K//block_k)
    blockwise scales along K.  int4 codes are packed two per byte, the even
    k in the low nibble."""
    M, N, K = _check(x, codes, scales, block_k, bits)
    if x.device.type == "cpu":
        return wqt_matmul_ref(x, codes, scales, block_k, bits == 4)
    if x.device.type != "cuda":
        raise ValueError(f"wqt_matmul runs on cuda or cpu, got {x.device}")
    if codes.device != x.device or scales.device != x.device:
        raise ValueError("x, codes and scales must be on one device")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("x", x), ("codes", codes), ("scales", scales)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    from repro_torch.kernels import _build
    lib = _build.lib()
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    row_bytes = codes.shape[1]
    vec_ok = int(row_bytes % 16 == 0 and codes.data_ptr() % 16 == 0)
    splits = lib.wqt_matmul_splits(M, N, K)
    # fp32 partial tiles of the K splits (kept alive through the launch)
    work = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.wqt_matmul_launch(x.data_ptr(), codes.data_ptr(),
                                scales.data_ptr(), out.data_ptr(),
                                work.data_ptr() if work is not None else None,
                                M, N, K, block_k, bits, _DTYPES[x.dtype],
                                vec_ok, stream)
    _build.check(err, "wqt_matmul")
    wqt_matmul.launches += 1
    return out


wqt_matmul.launches = 0
