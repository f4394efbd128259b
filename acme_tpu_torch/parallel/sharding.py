"""Lane-axis meshes of CUDA devices (``acme_tpu.parallel.sharding``).

Lanes (independent circuit instances: sweep points, channels, voices)
need no communication during a run, so a multi-device run is pure data
parallelism over the lane axis: ``FusedRunner(mesh=lane_mesh())`` gives
each device its contiguous share of the lanes and one kernel launch over
them, and gathers the outputs on the mesh's first device.  A mesh here is
a tuple of ``torch.device``: one axis, the lanes.
"""

from __future__ import annotations

import torch

__all__ = ["lane_mesh"]


def lane_mesh(n_devices: int | None = None, axis: str = "dp"):
    """The visible CUDA devices (the first ``n_devices`` of them, default
    all) as a tuple of ``torch.device``, for ``FusedRunner(mesh=...)``.
    ``axis`` names the lane axis in the JAX package's signature and is
    read nowhere: the tuple has one axis.  Without a card it raises; a
    mesh of CPU devices is written out, e.g. ``(torch.device("cpu"),) *
    8``."""
    if not torch.cuda.is_available():
        raise RuntimeError("lane_mesh: no CUDA card found (a CPU mesh is a "
                           "tuple of torch.device('cpu') entries)")
    devs = tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))
    if n_devices is not None:
        devs = devs[:n_devices]
    return devs
