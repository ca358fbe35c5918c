"""Gemma3-27B [hf:google/gemma-3-27b-pt family; 5:1 local:global, 128k ctx]."""
from repro_torch.configs.base import (
    ArchConfig, AttentionConfig, LMConfig, PQConfig, lm_shapes,
)

CONFIG = ArchConfig(
    arch_id="gemma3-27b",
    family="lm",
    model=LMConfig(
        name="gemma3-27b",
        n_layers=62,
        d_model=5376,
        d_ff=21504,
        vocab=262144,
        attention=AttentionConfig(
            n_heads=32, n_kv_heads=16, head_dim=128,
            qkv_bias=False, qk_norm=True, rope_theta=1_000_000.0,
            window=1024, local_global_ratio=5,   # 5 local : 1 global
        ),
        act="gelu",
        gated_mlp=True,          # GeGLU
        tie_embeddings=True,
        pq_head=PQConfig(m=8, b=256),
    ),
    # 5/6 of layers are O(window) sliding attention => long_500k runs.
    shapes=lm_shapes(sub_quadratic=True),
    source="hf:google/gemma-3-27b-pt",
)


def reduced() -> ArchConfig:
    from dataclasses import replace
    model = LMConfig(
        name="gemma3-27b-reduced",
        n_layers=6, d_model=64, d_ff=128, vocab=512,
        attention=AttentionConfig(
            n_heads=4, n_kv_heads=2, head_dim=16, qk_norm=True,
            window=8, local_global_ratio=5,
        ),
        act="gelu", gated_mlp=True, tie_embeddings=True,
        pq_head=PQConfig(m=4, b=16),
        dtype="float32", param_dtype="float32",
    )
    return replace(CONFIG, model=model)
