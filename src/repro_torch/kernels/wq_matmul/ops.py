"""Wrappers of the weight-quantized matmul CUDA kernels (``csrc/``):
``wqt_matmul`` (out-major codes) and ``wq_matmul`` (K-major codes), the two
entry points of ``wqt_matmul.cu``, and the two of ``wqt_matmul_a8.cu``
against out-major codes: ``wqt_matmul_a8`` (int8 activation codes and row
scales in, fp32 out) and ``wqt_matmul_a8_x`` (activations in, row-quantized
inside the launch, x's dtype out).

For a CUDA tensor each launches its kernel or raises; for a CPU tensor it
takes the plain version in ``ref.py``.  Each kernel's launches are counted
on its wrapper's ``.launches`` (both entries of ``wqt_matmul_a8.cu`` on
``wqt_matmul_a8.launches``); nothing else adds to them.  ``plan`` chooses how
``wqt_matmul.cu`` runs a call: its instance (tensor-core GEMV or GEMM for
bf16 x, fp32 FMA tiles otherwise), tile and K splits; ``a8_plan`` chooses
the tile and the K splits (one cluster) of ``wqt_matmul_a8.cu``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .. import _build
from .ref import (quantize_weights_ref, wq_matmul_ref, wqt_matmul_a8_ref,
                  wqt_matmul_a8_x_ref, wqt_matmul_ref)

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


# --------------------------------------------------------------------------
# The launch plan of wqt_matmul.cu (both layouts)
# --------------------------------------------------------------------------

SMS = 132                          # streaming multiprocessors of an H100 SXM
INSTANCES = ("gemv", "gemm", "fma")   # index = the C launcher's ``instance``
GEMV_K = 128                       # K step of the GEMV's pipeline stages
GEMM_K = 64                        # K step of the GEMM's
GEMM_TILE = 128                    # the GEMM's (M, N) block tile
FMA_K = 64
CLUSTER_SPLITS = 8                 # tensor-core splits: one cluster per tile
GEMM_MIN_SPLIT_K = 256             # the GEMM splits K no finer than this
GEMV_TARGET_BLOCKS = 2 * SMS       # the GEMV splits K up to about this grid
GEMM_SPLIT_BELOW = SMS             # the GEMM splits K below this many tiles


class Plan(NamedTuple):
    """How ``wqt_matmul.cu`` runs one call: the instance, its (M, N) block
    tile and K step, ``splits`` K splits (grid z) of ``k_per_split`` each,
    the grid's block count, and the global workspace of the FMA instance's
    split-K: fp32 partial tiles and one counter per tile (the tensor-core
    instances reduce their splits inside a cluster and need none)."""
    instance: str
    tile_m: int
    tile_n: int
    tile_k: int
    splits: int
    k_per_split: int
    blocks: int
    workspace_bytes: int
    counters: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split(tiles: int, units: int, target: int, max_splits: int):
    """(splits, units per split) of ``units`` K units so that
    ``tiles * splits`` reaches about ``target`` blocks."""
    units = max(units, 1)
    want = max(1, min(units, max_splits, _cdiv(target, tiles)))
    per = _cdiv(units, want)
    return _cdiv(units, per), per


@functools.lru_cache(maxsize=4096)
def plan(M: int, N: int, K: int, dtype: torch.dtype, bits: int,
         block_k: int, kmajor: bool = False, aligned: bool = True) -> Plan:
    """The launch plan for x (M, K) of ``dtype`` against (N, K) codes of
    ``bits`` (int4 and int8 share every plan today).

    ``aligned``: every code row and x start 16-byte aligned (K-major:
    N % 16 == 0).  bf16 x with aligned codes and ``block_k`` -1 or a
    multiple of 16 takes the tensor cores: the GEMV at M <= 16 (K a
    multiple of 128), the GEMM above (K a multiple of 64).  Anything else
    takes the fp32 FMA tiles.  K splits start at multiples of the K step
    and of ``block_k``, so no split cuts a quant block; the tensor-core
    instances split at most 8 ways (one cluster per tile).  The GEMV
    splits K toward about two blocks per SM and takes the widest tile (64,
    32 or 16 columns) whose grid then holds at least one block per SM; the
    GEMM splits K only where its tiles number fewer than the SMs."""
    tensor_core = (dtype == torch.bfloat16 and aligned
                   and (block_k == -1 or block_k % 16 == 0))
    if tensor_core and M <= 16 and K % GEMV_K == 0:
        unit = math.lcm(GEMV_K, block_k) if block_k > 0 else GEMV_K
        tile_m, tile_k, instance = (8 if M <= 8 else 16), GEMV_K, "gemv"
        for tile_n in (64, 32, 16):        # the widest that fills the SMs
            tiles = _cdiv(N, tile_n)
            splits, per = _split(tiles, K // unit, GEMV_TARGET_BLOCKS,
                                 CLUSTER_SPLITS)
            if tiles * splits >= SMS:
                break
    elif tensor_core and M > 16 and K % GEMM_K == 0:
        unit = math.lcm(GEMM_K, block_k) if block_k > 0 else GEMM_K
        tile_m = tile_n = GEMM_TILE
        tile_k, instance = GEMM_K, "gemm"
        tiles = _cdiv(M, tile_m) * _cdiv(N, tile_n)
        splits, per = _split(
            tiles, K // unit, SMS if tiles < GEMM_SPLIT_BELOW else 1,
            min(CLUSTER_SPLITS, max(1, K // max(GEMM_MIN_SPLIT_K, unit))))
    else:
        unit = tile_k = FMA_K
        tile_m, tile_n = (16, 128) if M <= 16 else (64, 64)
        tiles = _cdiv(M, tile_m) * _cdiv(N, tile_n)
        splits, per = _split(tiles, _cdiv(K, unit), 2 * SMS, _cdiv(K, unit))
        instance = "fma"
    tiles = _cdiv(M, tile_m) * _cdiv(N, tile_n)
    k_per_split = per * unit if splits > 1 else K
    global_split = instance == "fma" and splits > 1
    return Plan(instance, tile_m, tile_n, tile_k, splits, k_per_split,
                tiles * splits, splits * M * N * 4 if global_split else 0,
                tiles if global_split else 0)


def launch_plan(x: torch.Tensor, codes: torch.Tensor, block_k: int,
                bits: int, kmajor: bool = False) -> Plan:
    """``plan`` for these tensors (what the wrapper launches)."""
    M, K = x.shape
    N = codes.shape[1] if kmajor else codes.shape[0]
    vec_ok = _vec_ok(codes, N if kmajor else codes.shape[1])
    return plan(M, N, K, x.dtype, bits, block_k, kmajor,
                aligned=bool(vec_ok) and x.data_ptr() % 16 == 0)


_COUNTERS: dict = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """Zeroed int32 tile counters of the split-K reduction.  The kernel
    leaves them zero, so one buffer per (device, stream) serves every
    call on that stream."""
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def _launch(name: str, x, codes, scales, block_k: int, bits: int,
            kmajor: bool) -> torch.Tensor:
    """Launch ``wqt_matmul.cu``'s entry point for one layout."""
    lib = _build.lib()
    M, K = x.shape
    N = codes.shape[1] if kmajor else codes.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    p = launch_plan(x, codes, block_k, bits, kmajor)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    work = counters = None
    if p.workspace_bytes:
        # fp32 partial tiles of the K splits (kept alive through the launch)
        work = torch.empty(p.workspace_bytes // 4, dtype=torch.float32,
                           device=x.device)
        counters = _counters(x.device, stream, p.counters)
    entry = lib.wq_matmul_launch if kmajor else lib.wqt_matmul_launch
    err = entry(x.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                out.data_ptr(), work.data_ptr() if work is not None else None,
                counters.data_ptr() if counters is not None else None,
                M, N, K, block_k, bits, _DTYPES[x.dtype],
                INSTANCES.index(p.instance), p.tile_m, p.tile_n, p.splits,
                p.k_per_split, _vec_ok(codes, N if kmajor else codes.shape[1]),
                stream)
    _build.check(err, name)
    return out


def wqt_matmul(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
               block_k: int = -1, bits: int = 8) -> torch.Tensor:
    """x (M, K) @ dequant(codes (N, K[/2]), scales)^T -> (M, N) in x.dtype.

    ``block_k=-1``: one (1, 1) scale per matrix; otherwise (N, K//block_k)
    blockwise scales along K.  int4 codes are packed two per byte, the even
    k in the low nibble."""
    M, N, K = _check(x, codes, scales, block_k, bits)
    if _build.plain(x):
        return wqt_matmul_ref(x, codes, scales, block_k, bits == 4)
    _check_cuda("wqt_matmul", x=x, codes=codes, scales=scales)
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    out = _launch("wqt_matmul", x, codes, scales, block_k, bits, False)
    wqt_matmul.launches += 1
    return out


wqt_matmul.launches = 0


# --------------------------------------------------------------------------
# W4A8 / W8A8: the launch plan of wqt_matmul_a8.cu and its two entries
# --------------------------------------------------------------------------

A8_K = 128                 # K step of the kernel's pipeline stages
A8_STAGES = 4              # its cp.async ring depth (kStages)
A8_SMEM_MAX = 100 * 1024   # dynamic shared memory of a block: two per SM
# the int4 contraction sums 16 * c: |16 * acc| <= 16 * 127 * 8 * K < 2^31
A8_MAX_K = 131072
_A8_XDTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


class A8Plan(NamedTuple):
    """How ``wqt_matmul_a8.cu`` runs one call: blocks of ``tile_m`` x rows
    (8 or 16; ``m_tiles`` of them over grid.y) and ``tile_n`` weight rows,
    the ``splits`` K splits of ``k_per_split`` of each (m, n) tile launched
    as one cluster, the cluster ranks whose row maxima the quantizer
    combines (``amax_ranks``, all of them), the grid's block count and a
    block's dynamic shared memory."""
    tile_m: int
    tile_n: int
    m_tiles: int
    splits: int
    k_per_split: int
    amax_ranks: int
    blocks: int
    smem_bytes: int


def a8_smem(bits: int, x_bytes: int, tile_m: int, tile_n: int,
            k_per_split: int, block_k: int) -> int:
    """A block's dynamic shared memory (the kernel's ``Layout.total``): the
    code ring (rows padded to 80 or 160 bytes), the x codes (rows padded by
    32 bytes), blockwise the staged scales, and one region for the raw x
    slice and then, blockwise, the int32 sums of the split's quant blocks
    from each of the block's k-groups (k-groups x ``tile_n`` = 64)."""
    stride = A8_K // 2 + 16 if bits == 4 else A8_K + 32
    bps = k_per_split // block_k if block_k > 0 else 0
    return (A8_STAGES * tile_n * stride + tile_m * (k_per_split + 32)
            + bps * tile_n * 4 + max(tile_m * k_per_split * x_bytes,
                                     bps * tile_m * 64 * 4))


@functools.lru_cache(maxsize=4096)
def a8_plan(M: int, N: int, K: int, block_k: int, bits: int,
            x_bytes: int) -> A8Plan:
    """The launch plan for x (M, K) against (N, K) codes of ``bits``, x
    given as ``x_bytes``-byte activations (4 fp32, 2 bf16) or int8 codes
    (1).  Blocks take 8 rows of x at M <= 8, else 16 (M > 16 in several
    m tiles).  K is split toward about two blocks per SM, at most 8 ways
    (one cluster, which spans all of K), each split a multiple of 128 and
    of ``block_k``, and further where a block's slice of K would not fit
    its shared-memory budget; the widest tile (64, 32, 16 columns) whose
    grid then holds a block per SM.  Raises for a shape the kernel does
    not take."""
    if K % A8_K or K > A8_MAX_K:
        raise ValueError(f"the wqt_matmul_a8 kernel takes K a multiple of "
                         f"{A8_K} up to {A8_MAX_K}, got {K}")
    if block_k != -1 and (block_k <= 0 or block_k % 32 or K % block_k):
        raise ValueError(f"the wqt_matmul_a8 kernel takes block_k = -1 or "
                         f"a multiple of 32 dividing K, got {block_k}")
    unit = math.lcm(A8_K, block_k) if block_k > 0 else A8_K
    units = K // unit
    tile_m = 8 if M <= 8 else 16
    m_tiles = _cdiv(M, tile_m)
    best = None
    for tile_n in (64, 32, 16):
        tiles = _cdiv(N, tile_n) * m_tiles
        splits, _ = _split(tiles, units, GEMV_TARGET_BLOCKS, CLUSTER_SPLITS)
        # more splits where a block's slice of K is too big
        for want in range(splits, min(units, CLUSTER_SPLITS) + 1):
            per = _cdiv(units, want)
            smem = a8_smem(bits, x_bytes, tile_m, tile_n, per * unit,
                           block_k)
            if smem <= A8_SMEM_MAX:
                break
        else:
            continue
        splits = _cdiv(units, per)
        best = A8Plan(tile_m, tile_n, m_tiles, splits, per * unit, splits,
                      tiles * splits, smem)
        if tiles * splits >= SMS:
            break
    if best is None:
        raise ValueError(f"no wqt_matmul_a8 tile fits {A8_SMEM_MAX} bytes of "
                         f"shared memory for K={K}, block_k={block_k}")
    return best


def _launch_a8(name: str, x, xs, codes, scales, block_k: int, bits: int,
               out_dtype: torch.dtype) -> torch.Tensor:
    lib = _build.lib()
    M, K = x.shape
    N = codes.shape[0]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    if codes.data_ptr() % 16:
        raise ValueError(f"{name}: codes must start 16-byte aligned")
    if x.data_ptr() % 16:          # a view into another tensor's storage
        x = x.clone()
    p = a8_plan(M, N, K, block_k, bits, x.element_size())
    err = lib.wqt_matmul_a8_launch(
        x.data_ptr(), xs.data_ptr() if xs is not None else None,
        codes.data_ptr(), scales.data_ptr(), out.data_ptr(), M, N, K,
        block_k, bits, _A8_XDTYPES[x.dtype], p.tile_m, p.tile_n, p.splits,
        p.k_per_split, p.amax_ranks, p.smem_bytes,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, name)
    return out


def wqt_matmul_a8(xq: torch.Tensor, xs: torch.Tensor, codes: torch.Tensor,
                  scales: torch.Tensor, block_k: int = -1,
                  bits: int = 8) -> torch.Tensor:
    """W4A8 / W8A8: int8 activation codes xq (M, K) with fp32 row scales
    xs (M, 1) against out-major codes (N, K[/2]) -> fp32 (M, N).  The
    contraction is exact in int32 and both scales fold into an fp32
    epilogue (``wqt_matmul_a8_ref``'s order).  The kernel takes K a
    multiple of 128 and ``block_k`` -1 or a multiple of 32."""
    M, N, K = _check(xq, codes, scales, block_k, bits)
    if xq.dtype != torch.int8:
        raise ValueError(f"xq must be int8 codes, got {xq.dtype}")
    if tuple(xs.shape) != (M, 1) or xs.dtype != torch.float32:
        raise ValueError(f"xs must be float32 ({M}, 1), got {xs.dtype} "
                         f"{tuple(xs.shape)}")
    if _build.plain(xq):
        return wqt_matmul_a8_ref(xq, xs, codes, scales, block_k, bits == 4)
    _check_cuda("wqt_matmul_a8", xq=xq, xs=xs, codes=codes, scales=scales)
    out = _launch_a8("wqt_matmul_a8", xq, xs, codes, scales, block_k, bits,
                     torch.float32)
    wqt_matmul_a8.launches += 1
    return out


wqt_matmul_a8.launches = 0


def wqt_matmul_a8_x(x: torch.Tensor, codes: torch.Tensor,
                    scales: torch.Tensor, block_k: int = -1,
                    bits: int = 8) -> torch.Tensor:
    """W4A8 / W8A8 from the activations: x (M, K) bf16 or fp32 is
    row-quantized to int8 (``quantize_acts_ref``), contracted with
    out-major codes (N, K[/2]) as ``wqt_matmul_a8`` does and cast to
    x.dtype, in one launch -> (M, N) in x.dtype, bitwise equal to
    ``wqt_matmul_a8_x_ref``.  Kernel shapes as ``wqt_matmul_a8``."""
    M, N, K = _check(x, codes, scales, block_k, bits)
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if _build.plain(x):
        return wqt_matmul_a8_x_ref(x, codes, scales, block_k, bits == 4)
    _check_cuda("wqt_matmul_a8_x", x=x, codes=codes, scales=scales)
    out = _launch_a8("wqt_matmul_a8_x", x, None, codes, scales, block_k,
                     bits, x.dtype)
    wqt_matmul_a8.launches += 1          # the kernel's one count
    return out


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
    if _build.plain(x):
        return wq_matmul_ref(x, codes, scales, block_k, bits == 4)
    _check_cuda("wq_matmul", x=x, codes=codes, scales=scales)
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    out = _launch("wq_matmul", x, codes, scales, block_k, bits, True)
    wq_matmul.launches += 1
    return out


wq_matmul.launches = 0
