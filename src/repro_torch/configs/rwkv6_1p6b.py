"""RWKV6-1.6B "Finch" [arXiv:2404.05892]: attention-free, data-dependent
decay linear recurrence.  24L d_model=2048 d_ff=7168 vocab=65536."""

import dataclasses

from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="rwkv6-1.6b",
        n_layers=24,
        d_model=2048,
        n_heads=32,          # wkv heads = d_model / rwkv_head_dim
        n_kv_heads=32,
        d_ff=7168,
        vocab=65536,
        pattern=("rwkv",),
        rwkv_head_dim=64,
        tie_embeddings=False,
        sub_quadratic=True,   # O(1) state: run long_500k
        max_seq=524_288,
    )


def smoke_config() -> LMConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=128, rwkv_head_dim=16, rwkv_chunk=8, max_seq=64,
        remat=False, dtype="float32")
