"""DIEN [arXiv:1809.03672; interest evolution with AUGRU over 100-step history]."""
from repro_torch.configs.base import (ArchConfig, PQConfig, RecsysConfig,
                                      recsys_shapes)

CONFIG = ArchConfig(
    arch_id="dien",
    family="recsys",
    model=RecsysConfig(
        name="dien",
        kind="dien",
        n_dense=0,
        n_sparse=2,                      # (item, category) per position
        embed_dim=18,
        table_rows=(1_000_000, 2_000),
        mlp=(200, 80),
        seq_len=100,
        gru_dim=108,
        n_items=1_000_000,
        pq=PQConfig(m=6, b=256),
    ),
    shapes=recsys_shapes(),
    source="arXiv:1809.03672",
)


def reduced() -> ArchConfig:
    from dataclasses import replace
    model = RecsysConfig(
        name="dien-reduced",
        kind="dien",
        n_dense=0, n_sparse=2, embed_dim=8,
        table_rows=(512, 32),
        mlp=(32, 16), seq_len=10, gru_dim=24,
        n_items=512,
        pq=PQConfig(m=2, b=16),
    )
    return replace(CONFIG, model=model)
