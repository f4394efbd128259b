"""The scan engine split over a mesh of CPU devices, and state checkpoints.

* ``sharded_run`` and ``sharded_run_sweep`` over ``(torch.device("cpu"),)
  * 8``: each entry runs its contiguous L/8 lanes, gathered in lane order,
  bit for bit as the unsplit run in y, state, converged and iters (the
  lanes are independent); a lane count the mesh does not divide raises
  before anything runs;
* ``save_state`` / ``load_state`` round trips for the engine's state and
  the fused runner's, onto the device and dtype of ``like``;
* an engine state saved by the JAX package's ``save_state`` loads in the
  port (the same npz keys), and the port's run from it stays within
  -160 dB of the JAX engine's continuation; one the port saves loads in
  the JAX package leaf for leaf.
"""

import numpy as np
import pytest
import torch

import jax

from acme_tpu import models as JM
from acme_tpu.engine import compile_model as j_compile
from acme_tpu.utils import checkpoint as j_ckpt

from acme_tpu_torch import FusedRunner
from acme_tpu_torch import models as TM
from acme_tpu_torch import sweeps as S
from acme_tpu_torch.engine import compile_model
from acme_tpu_torch.parallel import (lane_sharding, shard_state, sharded_run,
                                     sharded_run_sweep)
from acme_tpu_torch.utils import load_state, save_state

FS = 44100
MESH = (torch.device("cpu"),) * 8


def _sine(n, f=1000.0):
    return np.sin(2 * np.pi * f / FS * np.arange(n))


def _leaves(state):
    return [state["x"]] + [v for w in state["warms"] for v in w]


def _same(a, b):
    (ya, sa, ia), (yb, sb, ib) = a, b
    assert torch.equal(ya, yb)
    assert all(torch.equal(p, q) for p, q in zip(_leaves(sa), _leaves(sb)))
    assert torch.equal(ia.converged, ib.converged)
    assert torch.equal(ia.iters, ib.iters)


def test_sharded_run_bitwise():
    cm = compile_model(TM.diodeclipper_model(), device="cpu")
    L, T = 128, 200
    u = np.stack([a * _sine(T)[None] for a in np.linspace(0.1, 3.0, L)])
    split = sharded_run(cm, u, MESH)
    whole = cm.run(u)
    _same(split, whole)
    assert bool(split[2].converged.all())
    # from a given state, split with the lanes
    st = whole[1]
    _same(sharded_run(cm, u, MESH, state=st), cm.run(u, state=st))


def test_sharded_run_sweep_bitwise():
    cm = compile_model(TM.birdie_model(), device="cpu")
    L, T = 128, 150
    u_time = 0.3 * _sine(T)[None]
    vols = np.linspace(0.05, 0.95, L)[:, None]
    _same(sharded_run_sweep(cm, u_time, vols, (1,), MESH),
          cm.run_sweep(u_time, vols, (1,)))


def test_lanes_not_divisible_raises():
    cm = compile_model(TM.diodeclipper_model(), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        sharded_run(cm, np.zeros((12, 1, 10)), MESH)
    with pytest.raises(ValueError, match="not divisible"):
        sharded_run_sweep(compile_model(TM.birdie_model(), device="cpu"),
                          np.zeros((1, 10)), np.zeros((12, 1)), (1,), MESH)
    with pytest.raises(ValueError, match="not divisible"):
        lane_sharding(MESH).slices(100)


def test_shard_state_splits_lanes():
    cm = compile_model(TM.birdie_model(), device="cpu")
    st = cm.run(np.zeros((16, 2, 5)))[1]
    parts = shard_state(st, MESH)
    assert len(parts) == 8
    for i, p in enumerate(parts):
        assert torch.equal(p["x"], st["x"][2 * i:2 * i + 2])
        for w, wp in zip(st["warms"], p["warms"]):
            assert torch.equal(wp.dzdp, w.dzdp[2 * i:2 * i + 2])


def test_checkpoint_round_trip_engine(tmp_path):
    cm = compile_model(TM.birdie_model(), device="cpu")
    u = np.stack([np.vstack([0.4 * _sine(100), np.full(100, v)])
                  for v in (0.2, 0.7)])
    y1, st, _ = cm.run(u)
    path = str(tmp_path / "engine_state")
    save_state(path, st)
    back = load_state(path, cm.initial_state(2))
    assert all(torch.equal(a, b) for a, b in zip(_leaves(st), _leaves(back)))
    _same(cm.run(u, state=back), cm.run(u, state=st))
    # onto like's dtype: a float32 engine's state
    cm32 = compile_model(TM.birdie_model(), dtype=torch.float32,
                         device="cpu")
    back32 = load_state(path + ".npz", cm32.initial_state(2))
    assert back32["x"].dtype == torch.float32


def test_checkpoint_round_trip_fused(tmp_path):
    fr = FusedRunner(TM.diodeclipper_model(), device="cpu", **S.PRODUCTION)
    u = (1.0 * _sine(32))[None]
    _, st, _ = fr.run(u, np.zeros((128, 0)))
    path = str(tmp_path / "fused_state.npz")
    save_state(path, st)
    back = load_state(path, fr.initial_state(128))
    assert set(back) == set(st)
    assert all(torch.equal(back[k], st[k]) for k in st)


def test_jax_checkpoint_continues_in_port(tmp_path):
    """The JAX engine runs a window and saves its state; the port loads
    the file and runs the next window, as does the JAX engine."""
    T = 300
    u = np.stack([np.vstack([0.5 * _sine(2 * T), np.full(2 * T, v)])
                  for v in (0.25, 0.9)])
    cj = j_compile(JM.birdie_model())
    _, st_j, _ = cj.run(u[:, :, :T])
    path = str(tmp_path / "jax_state.npz")
    j_ckpt.save_state(path, st_j)
    y2_j, _, _ = cj.run(u[:, :, T:], state=st_j)
    cm = compile_model(TM.birdie_model(), device="cpu")
    st = load_state(path, cm.initial_state(2))
    assert st["x"].dtype == torch.float64
    y2, _, info = cm.run(u[:, :, T:], state=st)
    y2_j = np.asarray(y2_j)
    err = np.abs(y2.numpy() - y2_j).max(axis=(1, 2))
    peak = np.abs(y2_j).max(axis=(1, 2))
    assert (20 * np.log10(err / peak + 1e-300)).max() < -160
    assert bool(info.converged.all())


def test_port_checkpoint_loads_in_jax(tmp_path):
    """A state the port saves loads in the JAX package, leaf for leaf."""
    cm = compile_model(TM.birdie_model(), device="cpu")
    u = np.stack([np.vstack([0.4 * _sine(50), np.full(50, v)])
                  for v in (0.2, 0.7)])
    _, st, _ = cm.run(u)
    path = str(tmp_path / "port_state.npz")
    save_state(path, st)
    like = j_compile(JM.birdie_model()).initial_state(2)
    back = j_ckpt.load_state(path, like)
    assert np.array_equal(np.asarray(back["x"]), st["x"].numpy())
    for w, wj in zip(st["warms"], back["warms"]):
        for a, b in zip(w, wj):
            assert np.array_equal(a.numpy(), np.asarray(b))
