"""Qwen2.5-14B [hf:Qwen/Qwen2.5-0.5B family; dense, GQA, QKV bias]."""
from repro_torch.configs.base import (
    ArchConfig, AttentionConfig, LMConfig, PQConfig, lm_shapes,
)

CONFIG = ArchConfig(
    arch_id="qwen2.5-14b",
    family="lm",
    model=LMConfig(
        name="qwen2.5-14b",
        n_layers=48,
        d_model=5120,
        d_ff=13824,
        vocab=152064,
        attention=AttentionConfig(
            n_heads=40, n_kv_heads=8, head_dim=128,
            qkv_bias=True, rope_theta=1_000_000.0,
        ),
        act="silu",
        gated_mlp=True,
        tie_embeddings=False,
        pq_head=PQConfig(m=8, b=256),
    ),
    # Pure full attention => long_500k documented-skip.
    shapes=lm_shapes(sub_quadratic=False),
    source="hf:Qwen/Qwen2.5-14B",
)


def reduced() -> ArchConfig:
    from dataclasses import replace
    model = LMConfig(
        name="qwen2.5-14b-reduced",
        n_layers=2, d_model=64, d_ff=128, vocab=512,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16, qkv_bias=True),
        act="silu", gated_mlp=True, tie_embeddings=False,
        pq_head=PQConfig(m=4, b=16),
        dtype="float32", param_dtype="float32",
    )
    return replace(CONFIG, model=model)
