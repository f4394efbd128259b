"""Multi-device runs: split the lane axis over a mesh of devices."""

from .sharding import lane_mesh

__all__ = ["lane_mesh"]
