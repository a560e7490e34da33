"""DBRX-132B [hf:databricks/dbrx-base]: 40L d_model=6144 48H (GQA kv=8)
MoE 16 experts top-4, per-expert d_ff=10752, vocab=100352."""

import dataclasses

from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="dbrx-132b",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=10752,
        vocab=100352,
        pattern=("attn",),
        ffn="moe",
        n_experts=16,
        top_k=4,
        mlp_kind="swiglu",
        rope_theta=500000.0,
        tie_embeddings=False,
        sub_quadratic=False,             # pure full attention: skip long_500k
        max_seq=32_768,
    )


def smoke_config() -> LMConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=64, vocab=128, n_experts=4, top_k=2,
        capacity_factor=4.0,  # drop-free so prefill==forward exactly
        max_seq=64, remat=False, dtype="float32")
