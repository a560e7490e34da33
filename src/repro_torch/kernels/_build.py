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
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import torch


def is_fake(x: torch.Tensor) -> bool:
    """``x`` is a fake tensor (``launch/dryrun.py`` traces a step on fake
    tensors, which hold no data and launch nothing)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(x, FakeTensor)


def plain(x: torch.Tensor) -> bool:
    """Whether a wrapper takes its kernel's plain version for ``x``: a CPU
    tensor, or a fake one."""
    return x.device.type == "cpu" or is_fake(x)

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
# C entry points: name -> argtypes; all return int (the *_launch ones
# return cudaGetLastError())
SIGNATURES = {
    "wqt_matmul_launch": [_P] * 6 + [_I] * 12 + [_P],
    "wqt_matmul_a8_launch": [_P] * 5 + [_I] * 12 + [_P],
    "wq_matmul_launch": [_P] * 6 + [_I] * 12 + [_P],
    "decode_attn_launch": [_P] * 7 + [_I] * 7 + [_F] + [_I] * 6 + [_P],
    "decode_attn_paged_launch": [_P] * 8 + [_I] * 8 + [_F] + [_I] * 6 + [_P],
    "quant_launch": [_P, _P, _P, _P, _L, _L, _L, _L, _L, _I, _I, _F, _I,
                     _I, _P],
    "quant_blocks_per_sm": [_I, _I, _I, _I],
    "lotion_reg_launch": [_P] * 5 + [_L] * 5 + [_I] * 3 + [_F] * 2
                         + [_I] * 2 + [_P, _P],
    "lotion_reg_blocks_per_sm": [_I, _I],
    "opt_step_launch": [_P] * 9 + [_L] * 5 + [_I] * 6 + [_F] * 11
                       + [_I, _P],
    "opt_step_blocks_per_sm": [_I] * 5,
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


THREADS = 256      # threads per block of the elementwise kernels (qm::kThreads)


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(index: int, entry: str, args: Tuple[int, ...]) -> int:
    with torch.cuda.device(index):
        per_sm = getattr(lib(), entry)(*args)
    if per_sm <= 0:
        raise RuntimeError(f"{entry}{args}: no block fits on an SM "
                           f"(CUDA error {-per_sm})")
    return per_sm


def co_resident(device: torch.device, entry: str, *args: int) -> int:
    """Blocks of a kernel instance that the card holds at once: the
    instance's occupancy per SM (the C entry point ``entry`` queries it)
    times the SM count.  A cooperative launch may not exceed it."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return _blocks_per_sm(index, entry, tuple(args)) * sms


def check_cuda_inputs(name: str, *tensors: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> None:
    """Raise unless every tensor is a contiguous ``dtype`` (fp32 unless
    given) tensor on the first one's CUDA device (what the elementwise
    kernels take)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: inputs must be on one device, got "
                             f"{t.device} and {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: the kernel takes {dtype}, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
