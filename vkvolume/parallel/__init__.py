from .mesh import (RAY_AXIS, VOL_AXIS, make_mesh, march_sharded,
                   march_volume_sharded, replicate, shard_rays)

__all__ = ["RAY_AXIS", "VOL_AXIS", "make_mesh", "march_sharded",
           "march_volume_sharded", "replicate", "shard_rays"]
