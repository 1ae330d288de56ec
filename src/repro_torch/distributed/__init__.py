"""Distribution layer of the port (``repro.distributed``): the sharding
rules as torch ``DeviceMesh`` / DTensor placements."""
from .sharding import (ShardingPolicy, param_specs, make_shard_fn,
                       cache_specs, named)

__all__ = ["ShardingPolicy", "param_specs", "make_shard_fn", "cache_specs",
           "named"]
