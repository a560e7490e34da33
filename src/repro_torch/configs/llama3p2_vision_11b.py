"""Llama-3.2-11B-Vision [hf:meta-llama/Llama-3.2-11B-Vision]: text decoder
with gated cross-attention layers interleaved every 5th layer (8 of 40);
the vision tower is a STUB — input_specs provides precomputed patch
embeddings (1601 tokens x 1280, one tile) that the model projects and
cross-attends to.  40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256."""

import dataclasses

from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="llama-3.2-vision-11b",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=128256,
        pattern=("attn",) * 4 + ("xattn",),   # 8 repeats
        n_image_tokens=1601,
        d_vision=1280,
        mlp_kind="swiglu",
        rope_theta=500000.0,
        tie_embeddings=False,
        sub_quadratic=False,
        max_seq=131_072,
    )


def smoke_config() -> LMConfig:
    return dataclasses.replace(
        config(), n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=128, pattern=("attn", "xattn"),
        n_image_tokens=8, d_vision=24, max_seq=64, remat=False,
        dtype="float32")
