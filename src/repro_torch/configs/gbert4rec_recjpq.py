"""gBERT4Rec + RecJPQ @ Booking.com scale (paper Table 3, BERT rows).

3 Transformer blocks, d=512, bidirectional encoder; m=8 splits, 34,742
items.
"""
from repro_torch.configs.base import (ArchConfig, PQConfig, SeqRecConfig,
                                      seqrec_shapes)

N_ITEMS = 34_742   # Booking.com (paper Table 1)

CONFIG = ArchConfig(
    arch_id="gbert4rec-recjpq",
    family="seqrec",
    model=SeqRecConfig(
        name="gbert4rec-recjpq",
        backbone="bert4rec",
        n_items=N_ITEMS,
        d_model=512,
        n_blocks=3,
        n_heads=8,
        d_ff=2048,
        max_seq_len=200,
        pq=PQConfig(m=8, b=256, assign="svd", code_dtype="uint8"),
        serve_method="pqtopk_fused",
    ),
    shapes=seqrec_shapes(N_ITEMS),
    source="RecSys'24 (this paper) + gSASRec [RecSys'23]",
)


def reduced() -> ArchConfig:
    from dataclasses import replace
    model = SeqRecConfig(
        name="gbert4rec-recjpq-reduced",
        backbone="bert4rec",
        n_items=1000, d_model=32, n_blocks=2, n_heads=2, d_ff=64,
        max_seq_len=16, n_negatives=16,
        pq=PQConfig(m=4, b=16, assign="svd", code_dtype="uint8"),
        serve_method="pqtopk_fused",
    )
    return replace(CONFIG, model=model)
