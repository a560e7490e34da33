"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B]: dense Qwen1.5 architecture.
32L d_model=4096 32H (kv=32) d_ff=13440 vocab=92416."""

import dataclasses

from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="codeqwen1.5-7b",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        head_dim=128,
        d_ff=13440,
        vocab=92416,
        pattern=("attn",),
        mlp_kind="swiglu",
        rope_theta=1000000.0,
        tie_embeddings=False,
        sub_quadratic=False,
        max_seq=65_536,
    )


def smoke_config() -> LMConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=128, max_seq=64, remat=False,
        dtype="float32")
