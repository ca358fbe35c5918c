"""BST — Behavior Sequence Transformer [arXiv:1905.06874; Alibaba/Taobao]."""
from repro_torch.configs.base import (ArchConfig, PQConfig, RecsysConfig,
                                      recsys_shapes)

CONFIG = ArchConfig(
    arch_id="bst",
    family="recsys",
    model=RecsysConfig(
        name="bst",
        kind="bst",
        n_dense=0,
        n_sparse=2,                      # (item, category) per position
        embed_dim=32,
        table_rows=(4_000_000, 10_000),  # Taobao-scale items + categories
        mlp=(1024, 512, 256),
        seq_len=20,
        n_blocks=1,
        n_heads=8,
        n_items=4_000_000,
        pq=PQConfig(m=8, b=256),
    ),
    shapes=recsys_shapes(),
    source="arXiv:1905.06874",
)


def reduced() -> ArchConfig:
    from dataclasses import replace
    model = RecsysConfig(
        name="bst-reduced",
        kind="bst",
        n_dense=0, n_sparse=2, embed_dim=16,
        table_rows=(512, 32),
        mlp=(64, 32), seq_len=8, n_blocks=1, n_heads=4,
        n_items=512,
        pq=PQConfig(m=4, b=16),
    )
    return replace(CONFIG, model=model)
