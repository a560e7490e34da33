"""Gemma3-12B [hf:google/gemma-3 family]: 5:1 local:global attention
(window 1024), QK-norm, dual RoPE theta (10k local / 1M global), 128k+
context.  48L d_model=3840 16H (GQA kv=8, head_dim 256) d_ff=15360
vocab=262144."""

import dataclasses

from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="gemma3-12b",
        n_layers=48,
        d_model=3840,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=15360,
        vocab=262144,
        pattern=("local",) * 5 + ("attn",),   # 8 repeats of 5:1
        window=1024,
        qk_norm=True,
        use_post_norm=True,
        emb_scale=True,
        mlp_kind="geglu",
        rope_theta=1000000.0,
        rope_theta_local=10000.0,
        tie_embeddings=True,
        sub_quadratic=True,   # 5/6 of layers sliding-window: run long_500k
        max_seq=524_288,
    )


def smoke_config() -> LMConfig:
    return dataclasses.replace(
        config(), n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=128, window=8,
        pattern=("local",) * 2 + ("attn",), max_seq=64, remat=False,
        dtype="float32")
