from repro_torch.configs.base import (ArchConfig, AttentionConfig, PQConfig,
                                      RecsysConfig, SeqRecConfig, ShapeSpec,
                                      get_config, get_reduced)

__all__ = ["ArchConfig", "AttentionConfig", "PQConfig", "RecsysConfig",
           "SeqRecConfig", "ShapeSpec", "get_config", "get_reduced"]
