"""Hand-written CUDA kernels of the port, one folder per TPU kernel.

Each folder holds the triplet ``csrc/*.cu`` (the kernel), ``ops.py`` (the
wrapper: launches the kernel for CUDA tensors, takes the plain version for
CPU tensors, counts its launches) and ``ref.py`` (the plain PyTorch
version).  ``_build.py`` compiles every ``csrc/*.cu`` at first use.
"""

from __future__ import annotations

from typing import Dict

from .decode_attn import decode_attn
from .wq_matmul import wqt_matmul

WRAPPERS = {"wqt_matmul": wqt_matmul, "decode_attn": decode_attn}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
