"""Granite-3.0-2B [hf:ibm-granite/granite-3.0-2b-base]: dense GQA.
40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155."""

import dataclasses

from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="granite-3-2b",
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab=49155,
        pattern=("attn",),
        mlp_kind="swiglu",
        rope_theta=10000.0,
        tie_embeddings=True,
        sub_quadratic=False,
        max_seq=32_768,
    )


def smoke_config() -> LMConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=131, max_seq=64, remat=False,
        dtype="float32")
