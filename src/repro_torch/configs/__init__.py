from repro_torch.configs.base import (
    ArchConfig, AttentionConfig, GNNConfig, LMConfig, MoEConfig, PQConfig,
    RecsysConfig, SeqRecConfig, ShapeSpec, get_config, get_reduced, list_archs,
)

__all__ = [
    "ArchConfig", "AttentionConfig", "GNNConfig", "LMConfig", "MoEConfig",
    "PQConfig", "RecsysConfig", "SeqRecConfig", "ShapeSpec",
    "get_config", "get_reduced", "list_archs",
]
