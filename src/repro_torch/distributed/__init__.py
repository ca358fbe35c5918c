"""Sharding over a mesh (``launch/mesh.py``): collectives and manual
regions, per-shard row blocks, parameter rules and activation plans."""
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (
    NamedSharding, P, ShardingPlan, activation_plan, constrain,
    param_shardings,
)

__all__ = ["sharding", "NamedSharding", "P", "ShardingPlan",
           "activation_plan", "constrain", "param_shardings"]
