"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``kernels/*/csrc/*.cu`` file is compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc -c`` per source,
all started together, then linked into one shared library with a plain C
interface.  The library lands in ``kernels/_build/`` (listed in
``.gitignore``) under a name keyed by a hash of the sources and flags, so
an edited source (or a ``csrc/*.cuh`` header) rebuilds and an unchanged
one loads at once.  Nothing
here runs at import time: the CPU tests import every module of the port
and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import torch

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
# C entry points: name -> argtypes; all return int (the *_launch ones
# return cudaGetLastError())
SIGNATURES = {
    "wqt_matmul_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _P],
    "wqt_matmul_splits": [_I, _I, _I],
    "wqt_matmul_a8_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _P],
    "wqt_matmul_a8_segments": [_I, _I, _I, _I],
    "wq_matmul_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _P],
    "decode_attn_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _F, _I, _I, _P],
    "decode_attn_paged_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _F, _I, _I, _P],
    "quant_launch": [_P, _P, _P, _P, _L, _L, _I, _I, _F, _I, _I, _P],
    "lotion_reg_launch": [_P, _P, _P, _P, _P, _P, _L, _L, _I, _I, _F, _F,
                          _I, _I, _P],
    "opt_step_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _I, _I, _I,
                        _I, _I, _I] + [_F] * 11 + [_I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(_KERNELS.glob("*/csrc/*.cu"))


def headers() -> List[Path]:
    return sorted(_KERNELS.glob("*/csrc/*.cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set CUDA_HOME or PATH)")


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + headers():
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source (in parallel) and link the shared library;
    returns its path.  Raises with nvcc's output if a compile fails."""
    srcs = sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libreprotorch_{_digest(srcs)}.so"
    if so.exists():
        return so
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{s.stem}_{os.getpid()}.o" for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    failed = []
    for s, p in zip(srcs, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{s.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", *NVCC_FLAGS, "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


# Grid of the one-pass elementwise kernels (quant, lotion_reg, opt_step):
# 4 elements per thread per pass, up to 8 blocks of 256 threads on each of
# the H100's 132 SMs, then a grid-stride loop.  For per-matrix scales the
# grid is 2-D, y over the matrices (at most 65535) and x over each
# matrix's elements.  A function of the shape alone, so the penalty
# partials are summed in the same order on every run.
MAX_GRID = 132 * 8


def grid_for(n: int, n_mats: int = 1) -> Tuple[int, int]:
    """(grid_x, grid_y) for n elements in n_mats matrices of n // n_mats."""
    gy = max(1, min(n_mats, 65535))
    per_mat = n // max(n_mats, 1)
    gx = max(1, min((per_mat + 1023) // 1024, MAX_GRID // gy))
    return gx, gy


def check_f32_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous fp32 tensor on the first
    one's CUDA device (what the elementwise kernels take)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: inputs must be on one device, got "
                             f"{t.device} and {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: the kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
