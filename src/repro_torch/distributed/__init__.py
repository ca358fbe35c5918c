"""Item sharding over a shard mesh (``launch/mesh.py``): collectives,
per-shard row blocks and the serve-path parameter rules."""
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import P, param_shardings

__all__ = ["sharding", "P", "param_shardings"]
