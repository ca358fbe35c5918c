"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B; MoE 128 experts top-8, GQA kv=4]."""
from repro_torch.configs.base import (
    ArchConfig, AttentionConfig, LMConfig, MoEConfig, PQConfig, lm_shapes,
)

CONFIG = ArchConfig(
    arch_id="qwen3-moe-30b-a3b",
    family="lm",
    model=LMConfig(
        name="qwen3-moe-30b-a3b",
        n_layers=48,
        d_model=2048,
        d_ff=768,                # per-expert d_ff
        vocab=151936,
        attention=AttentionConfig(
            n_heads=32, n_kv_heads=4, head_dim=128,
            qkv_bias=False, qk_norm=True, rope_theta=1_000_000.0,
        ),
        act="silu",
        gated_mlp=True,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768, n_shared=0),
        tie_embeddings=False,
        pq_head=PQConfig(m=8, b=256),
    ),
    shapes=lm_shapes(sub_quadratic=False),
    source="hf:Qwen/Qwen3-30B-A3B",
)


def reduced() -> ArchConfig:
    from dataclasses import replace
    model = LMConfig(
        name="qwen3-moe-30b-a3b-reduced",
        n_layers=2, d_model=64, d_ff=32, vocab=512,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16, qk_norm=True),
        act="silu", gated_mlp=True,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32),
        tie_embeddings=False,
        pq_head=PQConfig(m=4, b=16),
        dtype="float32", param_dtype="float32",
    )
    return replace(CONFIG, model=model)
