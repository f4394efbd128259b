"""Lanes split across devices on the CPU: ``FusedRunner(mesh=...)``.

The JAX runner shard_maps its kernel over a 1-D mesh
(``acme_tpu/ops/fused.py:2517-2528``): each device runs the kernel over
its own S/ndev lane blocks, partitioned into its own lane groups
(``_group_S(S_loc)``, ``:2406-2411``), with no collectives.  The port's
mesh is a sequence of torch devices; here ``(cpu,) * 8``, whose entries run
the plain version one after another, against

* the unsharded port, bit for bit in y, every state key, fails, iters and
  floored (lanes are independent, and the split slices the whole run's
  inputs, tables and state);
* the JAX runner over ``lane_mesh(8)`` (the root conftest.py's 8 virtual
  CPU devices) in interpret mode, as tests/test_parallel.py runs it: y
  within -90 dB of each lane's peak, fails and floored equal (the bound of
  tests/test_torch_configs.py).

Cases: tests/test_parallel.py's clipper configuration and its second call
carrying the state; a lane-group configuration, whose groups are each
entry's (256 lanes where the unsharded run has 1024); per-lane models
whose cycle does not restart on each entry; the two-phase and the steady
power-up; lane counts that do not split.
"""

import numpy as np
import pytest
import torch

import acme_tpu_torch as T
from acme_tpu import models as M
from acme_tpu.ops.fused import FusedRunner as JaxRunner
from acme_tpu.parallel import lane_mesh as jax_lane_mesh
from acme_tpu_torch import FusedRunner
from acme_tpu_torch import models as TM
from acme_tpu_torch.ops import fused as F
from acme_tpu_torch.parallel import lane_mesh
from acme_tpu_torch.sweeps import PRODUCTION as PROD
from test_torch_configs import hold_effort, lane_db

FS = 44100
CPU8 = (torch.device("cpu"),) * 8
# tests/test_parallel.py:69-90
NT = 48
KW = dict(newton_iters=12, tol=1e-9, compensated=False, extrapolate=False)
LEVELS = np.linspace(0.25, 1.5, 1024)[:, None]
# tests/test_torch_groups.py's inputs: one fast step, two 1024-lane
# groups unsplit, keep tests failing in the first 256 lanes only (the
# first entry's group)
GROUP_KW = dict(fast_iters=1, compensated=False, extrapolate=False,
                polish_iters=1, group_lanes=1024)
GT = 64


def sine(amp, n):
    return (amp * np.sin(2 * np.pi * 1000 / FS * np.arange(n)))[None, :]


def group_levels():
    """tests/test_torch_groups.py's ``levels(2048, 256)``: the first 256
    lanes at 0.01 to 3.0 (one fast step misses the keep test on some
    samples above about 0.33), every other lane at 0.01 to 0.05 (never)."""
    rng = np.random.default_rng(0)
    lv = rng.uniform(0.01, 0.05, 2048)
    lv[:256] = rng.uniform(0.01, 3.0, 256)
    return lv[:, None]


def assert_same(a, b):
    """Two runs' (y, state, info) equal bit for bit."""
    (ya, sa, ia), (yb, sb, ib) = a, b
    assert torch.equal(ya, yb)
    assert sorted(sa) == sorted(sb) == sorted(F.STATE_KEYS)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for name, x, y in zip(ia._fields, ia, ib):
        # tiers: None while tracing is off
        assert (x is None and y is None) or torch.equal(x, y), name


def port(kw, mesh=None, model=TM.diodeclipper_model, **extra):
    return FusedRunner(model(), lane_scale_idx=(0,), mesh=mesh,
                       device=None if mesh else "cpu", **kw, **extra)


@pytest.fixture(scope="module")
def jax_plain():
    """The JAX runner over the 8-device mesh in interpret mode, two calls
    (the second carrying the state), as tests/test_parallel.py runs it."""
    jr = JaxRunner(M.diodeclipper_model(), lane_scale_idx=(0,),
                   interpret=True, time_chunk=16, mesh=jax_lane_mesh(8),
                   **KW)
    u = sine(0.5, NT)
    y1, st, i1 = jr.run(u, LEVELS, check=False)
    y2, _, i2 = jr.run(u, LEVELS, state=st, check=False)
    return (np.asarray(y1), i1), (np.asarray(y2), i2)


def test_mesh_matches_unsharded_and_jax(jax_plain):
    u = sine(0.5, NT)
    loc, sh = port(KW), port(KW, CPU8)
    assert sh.device == torch.device("cpu") and sh.mesh == CPU8
    first_loc = loc.run(u, LEVELS)
    first_sh = sh.run(u, LEVELS)
    assert_same(first_sh, first_loc)
    second_loc = loc.run(u, LEVELS, state=first_loc[1])
    second_sh = sh.run(u, LEVELS, state=first_sh[1])
    assert_same(second_sh, second_loc)
    for (yt, _, it), (yj, ij) in zip((first_sh, second_sh), jax_plain):
        db = lane_db(yt.numpy(), yj)
        assert db.max() < -90.0, (db.max(), int(db.argmax()))
        np.testing.assert_array_equal(it.fails.numpy(), np.asarray(ij.fails))
        np.testing.assert_array_equal(it.floored.numpy(),
                                      np.asarray(ij.floored))


def test_mesh_launches_once_per_entry():
    """Each entry is one call of the step over its own lanes (1024 lanes on
    eight entries: 128 each), in lane order; the gathered result lies on
    the runner's device."""
    sh = port(KW, CPU8)
    calls = []

    def step(plan, u, lv, tol, gate, state, coef, group):
        calls.append((lv.shape[1], float(lv[0, 0])))
        return F.plain_run(plan, u, lv, tol, gate, state, coef, group)

    u, lv, tol, gate = sh.prepare_inputs(sine(0.5, 8), LEVELS)
    y, st, fails, iters, floored = sh._mesh_step(
        step, u, lv, tol, gate, sh.initial_state(1024),
        sh._coef_tables(1024), sh._group(1024))
    assert [n for n, _ in calls] == [128] * 8
    assert [v for _, v in calls] == [float(lv[0, 128 * d]) for d in range(8)]
    assert y.shape == (8, 1, 1024) and fails.shape == (1024,)
    assert iters.shape == (1, 1024) and floored.shape == (1024,)


@pytest.mark.parametrize("L", [128, 100, 1000])
def test_indivisible_lanes_raise(L):
    """tests/test_parallel.py:93-100: 128 lanes are one block, which eight
    entries cannot share; lane counts off the 128-lane blocks do not split
    either; both raise before any step runs."""
    sh = FusedRunner(TM.diodeclipper_model(), newton_iters=4,
                     compensated=False, extrapolate=False, mesh=CPU8)
    with pytest.raises(ValueError, match="not divisible"):
        sh.run(np.zeros((1, 8)), np.zeros((L, 0)))
    with pytest.raises(ValueError, match="not divisible"):
        sh.group_size(L)


def test_mesh_constructor():
    """The runner's device is the mesh's first entry; another raises, as
    does a mesh that mixes device types or is empty; ``mesh_axis`` is
    accepted and read nowhere."""
    m = TM.diodeclipper_model()
    fr = FusedRunner(m, mesh=["cpu", "cpu"], device="cpu", mesh_axis="x")
    assert fr.mesh == (torch.device("cpu"),) * 2
    assert fr.device == torch.device("cpu")
    for mesh in ((), [object()], ("cpu", "meta")):
        with pytest.raises(ValueError, match="mesh must be"):
            FusedRunner(m, mesh=mesh)
    with pytest.raises(ValueError, match="first entry"):
        FusedRunner(m, mesh=CPU8, device="meta")


@pytest.fixture(scope="module")
def group_runs():
    """The group configuration split over eight entries, and its
    unsharded twin: runner, inputs and outputs."""
    lv = group_levels()
    out = {}
    for name, mesh in (("sharded", CPU8), ("unsharded", None)):
        fr = port(GROUP_KW, mesh)
        out[name] = fr, fr.run(sine(1.5, GT), lv, check=False)
    return lv, out


def test_group_partition_is_per_entry(group_runs):
    """Each entry's 256 lanes are one group (``_group_S(2)``), where the
    unsharded run has two of 1024; the split run equals the unsharded
    port handed that partition by hand, bit for bit, and its evaluations
    differ from the unsharded partition's on some lane."""
    lv, runs = group_runs
    sh, (ys, ss, infos) = runs["sharded"]
    loc, (yl, _, infol) = runs["unsharded"]
    assert sh.plan.verify_group
    assert sh.group_size(2048) == 256 and loc.group_size(2048) == 1024
    u, lvt, tol, gate = loc.prepare_inputs(sine(1.5, GT), lv)
    y, st, fails, iters, floored = F.plain_run(
        loc.plan, u, lvt, tol, gate, loc.initial_state(2048),
        loc._coef_tables(2048), group=256)
    assert_same((ys, ss, infos),
                (y.permute(2, 1, 0), st,
                 F.FusedInfo(fails=fails, iters=iters.T, floored=floored)))
    # the unsharded group of 1024 takes the redo of its first 256 lanes;
    # the entries' groups of 256 after them do not
    moved = (infos.iters != infol.iters).any(1)
    assert not moved[:256].any() and moved[256:1024].any()
    assert not moved[1024:].any()


def test_group_split_matches_jax_interpret(group_runs):
    """Against the JAX runner's 8-device run, whose devices partition
    their own 256 lanes alike: y, fails, floored and each lane's
    evaluations (``hold_effort``)."""
    lv, runs = group_runs
    sh, (ys, _, infos) = runs["sharded"]
    jr = JaxRunner(M.diodeclipper_model(), lane_scale_idx=(0,),
                   interpret=True, compile_cache=False, time_chunk=GT,
                   mesh=jax_lane_mesh(8), **GROUP_KW)
    assert 128 * jr._group_S(2048 // 128 // 8) == sh.group_size(2048)
    yj, _, ij = jr.run(sine(1.5, GT), lv, check=False)
    db = lane_db(ys.numpy(), np.asarray(yj))
    assert db.max() < -90.0, (db.max(), int(db.argmax()))
    np.testing.assert_array_equal(infos.fails.numpy(), np.asarray(ij.fails))
    np.testing.assert_array_equal(infos.floored.numpy(),
                                  np.asarray(ij.floored))
    hold_effort(jr, sh, ij, infos)


def clipper_with_r1(r):
    """The diode clipper with another series resistor."""
    circ = TM.diodeclipper()
    circ.delete("r1")
    circ.add("r1", T.resistor(r))
    circ.connect(("r1", 1), ("j_in", "+"))
    circ.connect(("r1", 2), ("d1", "+"))
    return T.DiscreteModel(circ, 1 / FS)


def test_per_lane_models_split():
    """Three clippers as per-lane models over eight entries of 128 lanes
    (not a multiple of three): lane i runs models[i % 3] on every entry,
    since each entry's tables and state are sliced from the whole run's;
    bit for bit as unsharded, and a restarted cycle would differ."""
    rs = (820.0, 1500.0, 4700.0)
    runs = [FusedRunner([clipper_with_r1(r) for r in rs],
                        lane_scale_idx=(0,), mesh=mesh, device="cpu", **PROD)
            for mesh in (CPU8, None)]
    assert runs[0].nvar > 0
    lv = np.full((1024, 1), 1.0)
    u = sine(1.5, 32)
    out = [fr.run(u, lv) for fr in runs]
    assert_same(*out)
    y = out[0][0]
    assert float((y[128] - y[129]).abs().max()) > 1e-3
    assert torch.equal(y[128], y[131]) and torch.equal(y[128], y[2])


@pytest.mark.parametrize("powerup", ["safe", "steady"])
def test_powerup_split(powerup):
    """The two-phase power-up (its sibling runner inherits the mesh) and
    the steady start (built for the whole run, then sliced), at 1024
    input levels: bit for bit as unsharded."""
    kw = dict(PROD, powerup=powerup, powerup_samples=16)
    runs = [port(kw, mesh) for mesh in (CPU8, None)]
    if powerup == "safe":
        assert runs[0]._powerup_runner().mesh == CPU8
    u = sine(1.5, 32)
    lv = np.linspace(0.1, 2.0, 1024)[:, None]
    assert_same(*[fr.run(u, lv) for fr in runs])


def test_lane_mesh_needs_a_card():
    """``lane_mesh`` lists the visible cards and never the CPU."""
    if torch.cuda.is_available():
        mesh = lane_mesh()
        assert len(mesh) == torch.cuda.device_count()
        assert all(d.type == "cuda" for d in mesh)
        assert lane_mesh(1) == mesh[:1]
        return
    for n in (None, 1, 8):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            lane_mesh(n)
