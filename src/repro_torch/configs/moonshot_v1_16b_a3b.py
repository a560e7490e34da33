"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B]: 48L d_model=2048
16H (kv=16), fine-grained MoE: 64 experts top-6 with per-expert d_ff=1408
plus 2 shared experts, vocab=163840 (DeepSeek-V3-style arch)."""

import dataclasses

from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="moonshot-v1-16b-a3b",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab=163840,
        pattern=("attn",),
        ffn="moe",
        n_experts=64,
        top_k=6,
        n_shared_experts=2,
        mlp_kind="swiglu",
        rope_theta=50000.0,
        tie_embeddings=False,
        sub_quadratic=False,
        max_seq=32_768,
    )


def smoke_config() -> LMConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=32, vocab=128, n_experts=8, top_k=2,
        n_shared_experts=1, capacity_factor=8.0,  # drop-free for exactness
        max_seq=64, remat=False, dtype="float32")
