"""Architecture configs of the port's slice: ``config()`` is the full
published configuration, ``smoke_config()`` the reduced same-family one
used by the CPU tests (both copied from ``repro.configs``)."""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.lm import LMConfig

ARCHS = ["granite_3_2b", "gemma2_2b", "codeqwen1p5_7b", "gemma3_12b",
         "musicgen_medium", "dbrx_132b", "moonshot_v1_16b_a3b",
         "zamba2_2p7b", "rwkv6_1p6b", "llama3p2_vision_11b"]

# the dry-run's archs, in the order of the JAX package's registry
CELL_ARCHS = ["zamba2_2p7b", "dbrx_132b", "moonshot_v1_16b_a3b",
              "musicgen_medium", "rwkv6_1p6b", "gemma2_2b", "codeqwen1p5_7b",
              "granite_3_2b", "gemma3_12b", "llama3p2_vision_11b"]

# the cells of the JAX package's dry-run (global batch and length)
SHAPES = {
    "train_4k":    dict(seq_len=4_096,   global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32_768,  global_batch=32,  kind="prefill"),
    "decode_32k":  dict(seq_len=32_768,  global_batch=128, kind="decode"),
    "long_500k":   dict(seq_len=524_288, global_batch=1,   kind="decode"),
}


def _norm(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "p")


def _module(arch_id: str):
    name = _norm(arch_id)
    if name not in ARCHS:
        raise ValueError(f"unknown config {arch_id!r} (have {ARCHS})")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str) -> LMConfig:
    return _module(arch_id).config()


def get_smoke_config(arch_id: str) -> LMConfig:
    return _module(arch_id).smoke_config()


def cells(include_skipped: bool = False) -> List[tuple]:
    """All assigned (arch, shape) cells, in the JAX package's order,
    excluding long_500k for pure full-attention archs (with
    ``include_skipped`` those come as (arch, shape, "SKIP"))."""
    out = []
    for a in CELL_ARCHS:
        cfg = get_config(a)
        for s in SHAPES:
            if s == "long_500k" and not cfg.sub_quadratic:
                if include_skipped:
                    out.append((a, s, "SKIP"))
                continue
            out.append((a, s))
    return out
