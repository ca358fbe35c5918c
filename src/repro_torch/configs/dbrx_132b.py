"""DBRX-132B [hf:databricks/dbrx-base; MoE 16 experts top-4, fine-grained]."""
from repro_torch.configs.base import (
    ArchConfig, AttentionConfig, LMConfig, MoEConfig, PQConfig, lm_shapes,
)

CONFIG = ArchConfig(
    arch_id="dbrx-132b",
    family="lm",
    model=LMConfig(
        name="dbrx-132b",
        n_layers=40,
        d_model=6144,
        d_ff=10752,              # per-expert d_ff
        vocab=100352,
        attention=AttentionConfig(
            n_heads=48, n_kv_heads=8, head_dim=128,
            qkv_bias=False, rope_theta=500_000.0,
        ),
        act="silu",
        gated_mlp=True,
        moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752, n_shared=0),
        norm="layernorm",
        tie_embeddings=False,
        pq_head=PQConfig(m=8, b=256),
    ),
    shapes=lm_shapes(sub_quadratic=False),
    source="hf:databricks/dbrx-base",
)


def reduced() -> ArchConfig:
    from dataclasses import replace
    model = LMConfig(
        name="dbrx-132b-reduced",
        n_layers=2, d_model=64, d_ff=64, vocab=512,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16),
        act="silu", gated_mlp=True, norm="layernorm",
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64),
        tie_embeddings=False,
        pq_head=PQConfig(m=4, b=16),
        dtype="float32", param_dtype="float32",
    )
    return replace(CONFIG, model=model)
