"""MusicGen-medium [arXiv:2306.05284]: decoder-only over EnCodec tokens.
48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048, 4 codebooks (summed
embeddings, 4 output heads).  The EnCodec frontend is a STUB: input_specs
provides precomputed codebook token ids; the delay-pattern interleaving is
omitted (backbone-only assignment)."""

import dataclasses

from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="musicgen-medium",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        vocab=2048,
        pattern=("attn",),
        mlp_kind="gelu",
        n_codebooks=4,
        rope_theta=10000.0,
        tie_embeddings=False,
        sub_quadratic=False,
        max_seq=32_768,
    )


def smoke_config() -> LMConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=32, max_seq=64, remat=False,
        dtype="float32")
