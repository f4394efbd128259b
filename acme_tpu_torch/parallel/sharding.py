"""Lane-axis meshes of CUDA devices (``acme_tpu.parallel.sharding``).

Lanes (independent circuit instances: sweep points, channels, voices)
need no communication during a run, so a multi-device run is pure data
parallelism over the lane axis.  A mesh here is a tuple of
``torch.device``: one axis, the lanes.  ``FusedRunner(mesh=lane_mesh())``
gives each device its contiguous share of the lanes and one launch of the
fused kernel over them; ``sharded_run`` / ``sharded_run_sweep`` do the same
for the float64 scan engine (``engine.CompiledModel``).  CUDA entries each
launch on a stream of their own; the outputs are gathered on the engine's
device in lane order.  A mesh of CPU devices, e.g. ``(torch.device("cpu"),)
* 8``, runs the plain version entry by entry.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

__all__ = ["lane_mesh", "lane_sharding", "shard_state", "sharded_run",
           "sharded_run_sweep", "LaneSharding"]


def lane_mesh(n_devices: int | None = None, axis: str = "dp"):
    """The visible CUDA devices (the first ``n_devices`` of them, default
    all) as a tuple of ``torch.device``, for ``FusedRunner(mesh=...)`` and
    the sharded engine runs.  ``axis`` names the lane axis in the JAX
    package's signature and is read nowhere: the tuple has one axis.
    Without a card it raises; a mesh of CPU devices is written out, e.g.
    ``(torch.device("cpu"),) * 8``."""
    if not torch.cuda.is_available():
        raise RuntimeError("lane_mesh: no CUDA card found (a CPU mesh is a "
                           "tuple of torch.device('cpu') entries)")
    devs = tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))
    if n_devices is not None:
        devs = devs[:n_devices]
    return devs


class LaneSharding(NamedTuple):
    """The split of a lane axis over a mesh: entry i takes the i-th
    contiguous L/n lanes."""
    devices: tuple
    axis: str = "dp"

    def slices(self, L):
        """Each entry's lanes as a slice; ValueError unless the entries
        divide L."""
        n = len(self.devices)
        if L % n:
            raise ValueError(f"{L} lanes not divisible by {n} devices")
        Ld = L // n
        return [slice(i * Ld, (i + 1) * Ld) for i in range(n)]


def lane_sharding(mesh, axis: str = "dp") -> LaneSharding:
    """The split of the leading (lane) dimension over ``mesh``."""
    from ..ops.fused import _mesh_devices
    return LaneSharding(_mesh_devices(mesh), axis)


def _state_lanes(state, sl, dev):
    from ..ops.newton import WarmStart
    return {"x": state["x"][sl].to(dev),
            "warms": tuple(WarmStart(*(v[sl].to(dev) for v in w))
                           for w in state["warms"])}


def shard_state(state, mesh, axis: str = "dp"):
    """A CompiledModel scan carry split over ``mesh``: a tuple with each
    entry's contiguous lanes on its device."""
    sh = lane_sharding(mesh, axis)
    return tuple(_state_lanes(state, sl, d)
                 for sl, d in zip(sh.slices(state["x"].shape[0]),
                                  sh.devices))


def _mesh_scan(cm, state, src, T, mesh, axis):
    """``cm``'s scan once per mesh entry over the entry's lanes, the
    outputs gathered on ``cm.device`` in lane order (the JAX scan's lane
    sharding, no collectives).  CUDA entries each launch on a stream of
    their own, made to wait for the engine's current stream, which waits
    for every entry before the gather; CPU entries run one after another."""
    sh = lane_sharding(mesh, axis)
    L = state["x"].shape[0]
    slices = sh.slices(L)
    if sh.devices[0].type != cm.device.type:
        raise ValueError(f"mesh of {sh.devices[0].type} devices for an "
                         f"engine on {cm.device}")
    cuda = cm.device.type == "cuda"
    main = torch.cuda.current_stream(cm.device) if cuda else None
    inputs = [t for t in (src.ut, src.ul, src.lv) if t is not None] \
        + [state["x"]] + [v for w in state["warms"] for v in w]
    parts = []
    for sl, dev in zip(slices, sh.devices):
        with contextlib.ExitStack() as ctx:
            if cuda:
                s = torch.cuda.Stream(device=dev)
                ctx.enter_context(torch.cuda.device(dev))
                ctx.enter_context(torch.cuda.stream(s))
                s.wait_stream(main)
                for t in inputs:
                    # read on s: not freed for reuse before s is done
                    t.record_stream(s)
            out = cm._scan(_state_lanes(state, sl, dev), src.lanes(sl, dev),
                           T)
            if cuda:
                done = torch.cuda.Event()
                done.record(s)
                parts.append((out, done))
            else:
                parts.append((out, None))
    outs = []
    for out, done in parts:
        st, (y, conv, iters) = out
        if done is not None:
            main.wait_event(done)
            for t in [y, conv, iters, st["x"]] + [
                    v for w in st["warms"] for v in w]:
                # read by the gather on the engine's stream
                t.record_stream(main)
        outs.append(out)
    dev = cm.device
    cat = lambda ts, dim: torch.cat([t.to(dev) for t in ts], dim=dim)
    sts, rest = zip(*outs)
    ys, convs, iters = zip(*rest)
    state = {"x": cat([s["x"] for s in sts], 0),
             "warms": tuple(type(w)(*(cat([s["warms"][k][f] for s in sts], 0)
                                      for f in range(3)))
                            for k, w in enumerate(sts[0]["warms"]))}
    return state, (cat(ys, 1), cat(convs, 1), cat(iters, 1))


def sharded_run(cm, u, mesh, axis: str = "dp", state=None):
    """Run a CompiledModel with lanes split over ``mesh``.

    ``u``: (L, nu, T) with L divisible by the mesh's size (else ValueError
    before anything runs).  ``state`` (default: ``cm.initial_state(L)``)
    is split with the lanes.  Returns (y (L, ny, T), state, RunInfo), as
    ``cm.run`` without its warn path."""
    from ..engine import RunInfo, _Src
    u = cm._as(u)
    if u.dim() != 3:
        raise ValueError("sharded_run expects a (L, nu, T) batch")
    L = u.shape[0]
    lane_sharding(mesh, axis).slices(L)
    if state is None:
        state = cm.initial_state(L)
    src = _Src(umap=tuple((2, i) for i in range(cm.nu)), ul=u)
    state, (y_tm, conv, iters) = _mesh_scan(cm, state, src, u.shape[2], mesh,
                                            axis)
    return y_tm.permute(1, 2, 0), state, RunInfo(converged=conv, iters=iters)


def sharded_run_sweep(cm, u_time, lane_values, lane_input_idx, mesh,
                      axis: str = "dp", state=None):
    """Parameter-sweep run (``cm.run_sweep``) with the lane-constant table
    split over ``mesh`` and the time rows given to every entry."""
    from ..engine import RunInfo
    u_time, lane_values = cm._as(u_time), cm._as(lane_values)
    L = lane_values.shape[0]
    lane_sharding(mesh, axis).slices(L)
    src = cm._sweep_src(u_time, lane_values, lane_input_idx)
    if state is None:
        state = cm.initial_state(L)
    state, (y_tm, conv, iters) = _mesh_scan(cm, state, src, u_time.shape[1],
                                            mesh, axis)
    return y_tm.permute(1, 2, 0), state, RunInfo(converged=conv, iters=iters)
