"""Gemma2-2B [arXiv:2408.00118]: alternating local(4096-window)/global
attention, logit soft-capping (attn 50, final 30), sandwich norms, GeGLU.
26L d_model=2304 8H (GQA kv=4, head_dim 256) d_ff=9216 vocab=256000."""

import dataclasses

from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="gemma2-2b",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab=256000,
        pattern=("local", "attn"),      # 13 repeats
        window=4096,
        softcap_attn=50.0,
        softcap_final=30.0,
        use_post_norm=True,
        emb_scale=True,
        mlp_kind="geglu",
        rope_theta=10000.0,
        tie_embeddings=True,
        sub_quadratic=True,
        max_seq=524_288,
    )


def smoke_config() -> LMConfig:
    return dataclasses.replace(
        config(), n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=128, window=8, max_seq=64,
        remat=False, dtype="float32")
