"""Hand-written CUDA kernels of the port, one folder per TPU kernel.

Each folder holds the triplet ``csrc/*.cu`` (the kernel), ``ops.py`` (the
wrapper: launches the kernel for CUDA tensors, takes the plain version for
CPU tensors, counts its launches) and ``ref.py`` (the plain PyTorch
version).  ``_build.py`` compiles every ``csrc/*.cu`` at first use.
"""

from __future__ import annotations

from typing import Dict

from .decode_attn import decode_attn, decode_attn_paged
from .lotion_reg import lotion_penalty_fused_vg
from .opt_step import fused_opt_step_leaf
from .quant import quant_rr, quant_rtn
from .wq_matmul import wq_matmul, wqt_matmul, wqt_matmul_a8

# kernel name -> the wrappers that launch it (quant: the RTN and RR casts)
WRAPPERS = {"wqt_matmul": (wqt_matmul,), "decode_attn": (decode_attn,),
            "wqt_matmul_a8": (wqt_matmul_a8,),
            "decode_attn_paged": (decode_attn_paged,),
            "wq_matmul": (wq_matmul,),
            "quant": (quant_rtn, quant_rr), "lotion_reg": (lotion_penalty_fused_vg,),
            "opt_step": (fused_opt_step_leaf,)}


def reset_launch_counts() -> None:
    for fns in WRAPPERS.values():
        for fn in fns:
            fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: sum(fn.launches for fn in fns)
            for name, fns in WRAPPERS.items()}
