"""Nemotron-4-340B [arXiv:2402.16819; dense, GQA, squared-ReLU, non-gated]."""
from repro_torch.configs.base import (
    ArchConfig, AttentionConfig, LMConfig, PQConfig, lm_shapes,
)

CONFIG = ArchConfig(
    arch_id="nemotron-4-340b",
    family="lm",
    model=LMConfig(
        name="nemotron-4-340b",
        n_layers=96,
        d_model=18432,
        d_ff=73728,
        vocab=256000,
        attention=AttentionConfig(
            n_heads=96, n_kv_heads=8, head_dim=192,
            qkv_bias=False, rope_theta=10_000.0,
        ),
        act="sqrelu",
        gated_mlp=False,          # Nemotron uses a plain 2-matrix FFN
        norm="layernorm",
        tie_embeddings=False,
        pq_head=PQConfig(m=8, b=256),
        moment_dtype="bfloat16",  # 340B: bf16 Adam moments (DESIGN.md §8)
    ),
    shapes=lm_shapes(sub_quadratic=False),
    source="arXiv:2402.16819",
)


def reduced() -> ArchConfig:
    from dataclasses import replace
    model = LMConfig(
        name="nemotron-4-340b-reduced",
        n_layers=2, d_model=96, d_ff=384, vocab=512,
        attention=AttentionConfig(n_heads=6, n_kv_heads=2, head_dim=16),
        act="sqrelu", gated_mlp=False, norm="layernorm", tie_embeddings=False,
        pq_head=PQConfig(m=4, b=16),
        dtype="float32", param_dtype="float32",
    )
    return replace(CONFIG, model=model)
