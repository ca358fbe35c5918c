"""SASRec + RecJPQ @ Gowalla scale — the paper's primary model (Table 3).

2 Transformer blocks, d=512, m=8 splits (paper §4), b=512 sub-ids/split
(RecJPQ's Gowalla setting), 1,271,638 items.
"""
from repro_torch.configs.base import (ArchConfig, PQConfig, SeqRecConfig,
                                      seqrec_shapes)

N_ITEMS = 1_271_638   # Gowalla (paper Table 1)

CONFIG = ArchConfig(
    arch_id="sasrec-recjpq",
    family="seqrec",
    model=SeqRecConfig(
        name="sasrec-recjpq",
        backbone="sasrec",
        n_items=N_ITEMS,
        d_model=512,
        n_blocks=2,
        n_heads=8,
        d_ff=512,
        max_seq_len=200,
        pq=PQConfig(m=8, b=512, assign="svd", code_dtype="uint16"),
        serve_method="pqtopk_fused",
    ),
    shapes=seqrec_shapes(N_ITEMS),
    source="RecSys'24 (this paper) + RecJPQ [WSDM'24]",
)


def reduced() -> ArchConfig:
    from dataclasses import replace
    model = SeqRecConfig(
        name="sasrec-recjpq-reduced",
        backbone="sasrec",
        n_items=1000, d_model=32, n_blocks=2, n_heads=2, d_ff=32,
        max_seq_len=16, n_negatives=16,
        pq=PQConfig(m=4, b=16, assign="svd"),
        serve_method="pqtopk_fused",
    )
    return replace(CONFIG, model=model)
