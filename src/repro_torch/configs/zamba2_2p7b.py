"""Zamba2-2.7B [arXiv:2411.15242]: hybrid Mamba2 backbone with a SHARED
full-attention+MLP transformer block invoked every 6 Mamba2 blocks (we
apply the shared block once per scan group of 6; the per-invocation LoRA
deltas of the published model are omitted — deviation noted in DESIGN.md).
54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000 ssm_state=64."""

import dataclasses

from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="zamba2-2.7b",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab=32000,
        pattern=("mamba",) * 6,          # 9 scan groups
        shared_attn_every=6,
        mlp_kind="gelu",
        ssm_state=64,
        ssm_head_dim=64,
        rope_theta=10000.0,
        tie_embeddings=True,
        sub_quadratic=True,              # SSM backbone: run long_500k
        max_seq=524_288,
    )


def smoke_config() -> LMConfig:
    return dataclasses.replace(
        config(), n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=128, pattern=("mamba",) * 2,
        shared_attn_every=2, ssm_state=8, ssm_head_dim=16, ssm_chunk=8,
        max_seq=64, remat=False, dtype="float32")
