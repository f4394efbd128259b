"""Multi-device runs: split the lane axis over a mesh of devices."""

from .sharding import (lane_mesh, lane_sharding, shard_state, sharded_run,
                       sharded_run_sweep)

__all__ = ["lane_mesh", "shard_state", "lane_sharding", "sharded_run",
           "sharded_run_sweep"]
