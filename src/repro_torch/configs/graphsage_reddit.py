"""GraphSAGE [arXiv:1706.02216; 2 layers, d=128, mean aggregator, fanout 25-10].

The paper's PQ/PQTopK technique is NOT applicable to this arch (node
classification: no million-id scoring step) — see DESIGN.md §4.  Implemented
without the technique, sharing the segment_sum message-passing substrate.
"""
from repro_torch.configs.base import ArchConfig, GNNConfig, gnn_shapes

CONFIG = ArchConfig(
    arch_id="graphsage-reddit",
    family="gnn",
    model=GNNConfig(
        name="graphsage-reddit",
        n_layers=2,
        d_hidden=128,
        aggregator="mean",
        sample_sizes=(25, 10),
        n_classes=41,
    ),
    shapes=gnn_shapes(),
    source="arXiv:1706.02216",
    notes="PQ retrieval head inapplicable (DESIGN.md §4).",
)


def reduced() -> ArchConfig:
    from dataclasses import replace
    model = GNNConfig(
        name="graphsage-reduced",
        n_layers=2, d_hidden=16, aggregator="mean",
        sample_sizes=(5, 3), n_classes=7,
    )
    return replace(CONFIG, model=model)
