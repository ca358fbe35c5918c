"""Factorization Machine [Rendle, ICDM'10; 39 fields, k=10, O(nk) sum-square].

The FM item term <v_user, v_item> is exactly dot-product retrieval, so the
``retrieval_cand`` shape is a direct application of the paper's PQTopK
(d=10 -> m=2 splits of 5).
"""
from repro_torch.configs.base import (ArchConfig, PQConfig, RecsysConfig,
                                      recsys_shapes)
from repro_torch.configs.dcn_v2 import CRITEO_VOCABS

# 13 bucketised dense features (64 buckets each) + 26 categorical fields.
FM_VOCABS = tuple([64] * 13) + CRITEO_VOCABS

CONFIG = ArchConfig(
    arch_id="fm",
    family="recsys",
    model=RecsysConfig(
        name="fm",
        kind="fm",
        n_dense=0,
        n_sparse=39,
        embed_dim=10,
        table_rows=FM_VOCABS,
        n_items=1_000_000,
        pq=PQConfig(m=2, b=256),
    ),
    shapes=recsys_shapes(),
    source="Rendle ICDM'10",
)


def reduced() -> ArchConfig:
    from dataclasses import replace
    model = RecsysConfig(
        name="fm-reduced",
        kind="fm",
        n_dense=0, n_sparse=6, embed_dim=8,
        table_rows=(64, 32, 128, 16, 8, 256),
        n_items=512,
        pq=PQConfig(m=2, b=16),
    )
    return replace(CONFIG, model=model)
