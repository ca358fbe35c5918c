"""DCN-v2 [arXiv:2008.13535; Criteo: 13 dense, 26 sparse, 3 cross layers].

Retrieval shape uses the PQ cascade: PQTopK over PQ-compressed item-id
embeddings -> full cross+MLP re-rank of the top slate.
"""
from repro_torch.configs.base import (ArchConfig, PQConfig, RecsysConfig,
                                      recsys_shapes)

# Standard Criteo-Kaggle categorical vocab sizes (26 fields).
CRITEO_VOCABS = (
    1460, 583, 10_131_227, 2_202_608, 305, 24, 12_517, 633, 3, 93_145,
    5_683, 8_351_593, 3_194, 27, 14_992, 5_461_306, 10, 5_652, 2_173, 4,
    7_046_547, 18, 15, 286_181, 105, 142_572,
)

CONFIG = ArchConfig(
    arch_id="dcn-v2",
    family="recsys",
    model=RecsysConfig(
        name="dcn-v2",
        kind="dcn",
        n_dense=13,
        n_sparse=26,
        embed_dim=16,
        table_rows=CRITEO_VOCABS,
        mlp=(1024, 1024, 512),
        n_cross_layers=3,
        n_items=1_000_000,
        pq=PQConfig(m=4, b=256),
    ),
    shapes=recsys_shapes(),
    source="arXiv:2008.13535",
)


def reduced() -> ArchConfig:
    from dataclasses import replace
    model = RecsysConfig(
        name="dcn-v2-reduced",
        kind="dcn",
        n_dense=4, n_sparse=6, embed_dim=8,
        table_rows=(64, 32, 128, 16, 8, 256),
        mlp=(64, 32), n_cross_layers=2,
        n_items=512,
        pq=PQConfig(m=2, b=16),
    )
    return replace(CONFIG, model=model)
