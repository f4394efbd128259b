"""The CUDA kernel's own source, compiled for the CPU and checked here.

``acme_tpu_torch/ops/csrc`` is written as ``__host__ __device__`` code, so
g++ compiles it (``-std=c++17 -O2 -ffp-contract=off``, with the model
header that emit.py writes) into a shared library whose host entry runs
the kernel's per-lane step lane by lane.  Against the plain torch version:

* df arithmetic (``df.cuh``) and the tiny solves (``linsolve.cuh``) on
  identical inputs: bit for bit (TwoProd's fused multiply-add error is
  exact, as is the plain version's Dekker split);
* the whole step on the clipper, birdie (pot as a lane input) and the
  Super Over from its committed seeds, and the level sweep's two
  configurations (the power-up sibling from cold, the production runner
  from the sibling's state) on the clipper and the level Super Over, the
  same two for a list of models (per-lane coefficient tables: four
  clippers, three Super Over presets) and for the un-decomposed Super Over
  (one 7x7 subsystem with five right-hand columns in its df elimination):
  y within -90 dB of each lane's peak (the bound of the other comparisons;
  so far the two agree exactly), with fails and floored equal;
* a build that couples lane groups (each lane of a group on a thread of
  its own, meeting the others at every keep test), two groups of 1024:
  bit for bit in y, state, fails, floored and iters (both sides round
  the float64 exp on the CPU);
* of the whole steps above, the Super Over from its seeds (the main
  path's build) and the un-decomposed Super Over's two builds are held
  bit for bit in y, state, fails, floored and iters rather than at
  -90 dB, the main path's also with a lane that takes the redo ladder
  beside lanes that do not, and as two chained launches against one
  (with and without such a lane; and the full path's production build).

Skipped where g++ is absent.  A kernel logic fault shows here before any
time on the card is spent.
"""

import copy
import os
import shutil

import numpy as np
import pytest
import torch

import acme_tpu_torch as T
from acme_tpu_torch import FusedRunner
from acme_tpu_torch import models as M
from acme_tpu_torch import sweeps as S
from acme_tpu_torch.convert import load_steady_seed
from acme_tpu_torch.ops import dfmath as tdf
from acme_tpu_torch.ops import fused as F
from acme_tpu_torch.ops.build import load_host
from acme_tpu_torch.ops.linsolve_tiny import solve_rows
from torch_step_configs import CONFIGS, LEVEL_CONFIGS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX bench's production configuration, which these builds hold
PROD = S.PRODUCTION


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not found")
    out = str(tmp_path_factory.mktemp("acme_build"))
    clip = FusedRunner(M.diodeclipper_model(), **PROD, device="cpu")
    return load_host(clip.plan, out), out


def _ptr(a):
    return a.ctypes.data


DF_OPS = {0: lambda a, b: a + b, 1: lambda a, b: a - b,
          2: lambda a, b: a * b, 3: lambda a, b: a / b,
          4: lambda a, b: tdf.exp(a), 5: lambda a, b: tdf.expm1(a),
          6: lambda a, b: tdf.tanh(a), 7: lambda a, b: tdf.sqrt(tdf.abs(a)),
          8: lambda a, b: tdf.abs(a), 9: lambda a, b: tdf.minimum(a, b),
          10: lambda a, b: tdf.maximum(a, b), 11: lambda a, b: -a}


@pytest.mark.parametrize("op", sorted(DF_OPS))
def test_df_ops_bitwise(host_lib, op):
    lib, _ = host_lib
    rng = np.random.default_rng(op)
    n = 1024
    scale = 30.0 if op in (4, 5) else 3.0
    ah = (rng.standard_normal(n) * scale).astype(np.float32)
    al = (ah * rng.uniform(-2 ** -25, 2 ** -25, n)).astype(np.float32)
    bh = (rng.standard_normal(n) * 2.0).astype(np.float32)
    bl = (bh * rng.uniform(-2 ** -25, 2 ** -25, n)).astype(np.float32)
    if op == 7:
        ah, al = np.abs(ah), np.where(ah < 0, -al, al).astype(np.float32)
    oh = np.empty(n, np.float32)
    ol = np.empty(n, np.float32)
    assert lib.acme_df_op_host(op, n, _ptr(ah), _ptr(al), _ptr(bh),
                               _ptr(bl), _ptr(oh), _ptr(ol)) == 0
    a = tdf.DF(torch.from_numpy(ah), torch.from_numpy(al))
    b = tdf.DF(torch.from_numpy(bh), torch.from_numpy(bl))
    r = DF_OPS[op](a, b)
    np.testing.assert_array_equal(oh, r.hi.numpy())
    np.testing.assert_array_equal(ol, r.lo.numpy())


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("m,use_df,refine", [(1, 0, 0), (3, 0, 1),
                                             (1, 1, 0), (3, 1, 0)])
def test_solves_bitwise(host_lib, n, m, use_df, refine):
    lib, _ = host_lib
    rng = np.random.default_rng(10 * n + m)
    count = 64
    J = rng.normal(size=(count, n, n)) * 10.0 ** rng.uniform(
        -6, 2, (count, n, 1))
    R = rng.normal(size=(count, m, n))
    Jh = J.astype(np.float32)
    Jl = (J - Jh).astype(np.float32)
    Rh = R.astype(np.float32)
    Rl = (R - Rh).astype(np.float32)
    Xh = np.empty((count, m, n), np.float32)
    Xl = np.zeros((count, m, n), np.float32)
    assert lib.acme_solve_host(n, m, count, use_df, refine, 1, _ptr(Jh),
                               _ptr(Jl), _ptr(Rh), _ptr(Rl), _ptr(Xh),
                               _ptr(Xl)) == 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    if use_df:
        Jt = [[tdf.DF(t(Jh[:, i, j]), t(Jl[:, i, j])) for j in range(n)]
              for i in range(n)]
        Rt = [[tdf.DF(t(Rh[:, k, i]), t(Rl[:, k, i])) for i in range(n)]
              for k in range(m)]
        X = solve_rows(Jt, Rt, refine=refine, pivot=True, xp=tdf)
        for k in range(m):
            for i in range(n):
                np.testing.assert_array_equal(Xh[:, k, i], X[k][i].hi.numpy())
                np.testing.assert_array_equal(Xl[:, k, i], X[k][i].lo.numpy())
    else:
        Jt = [[t(Jh[:, i, j]) for j in range(n)] for i in range(n)]
        Rt = [[t(Rh[:, k, i]) for i in range(n)] for k in range(m)]
        X = solve_rows(Jt, Rt, refine=refine, pivot=True)
        for k in range(m):
            for i in range(n):
                np.testing.assert_array_equal(Xh[:, k, i], X[k][i].numpy())


def _compare(lib, fr, u_time, lane_values, state, pairs=False):
    """The host build against plain_run; returns the plain version's state.
    ``pairs``: hold x + xlo and z + zlo as the values they carry instead of
    each part alone (libm's expf and torch's exp can differ by an ulp; a
    solve that moves by an ulp leaves the carried value within the bound
    but its lo part, 1e-7 of it, anywhere)."""
    u, lv, tol, gate = fr.prepare_inputs(u_time, lane_values)
    coef = fr._coef_tables(lv.shape[1])
    yh, sh, fh, ih, flh = F.host_step(lib, fr.plan, u, lv, tol, gate, state,
                                      coef)
    yp, sp, fp, ip, flp = F.plain_run(fr.plan, u, lv, tol, gate, state, coef)
    yh = yh.double().numpy()
    yp = yp.double().numpy()
    err = np.abs(yh - yp).max(axis=(0, 1))
    peak = np.maximum(np.abs(yp).max(axis=(0, 1)), 1e-30)
    assert (20 * np.log10(err / peak + 1e-300)).max() < -90.0
    assert torch.equal(fh, fp) and torch.equal(flh, flp)
    def vals(st):
        if not pairs:
            return st
        out = {k: v for k, v in st.items() if k not in ("xlo", "zlo")}
        out["x"] = st["x"].double() + st["xlo"].double()
        out["z"] = st["z"].double() + st["zlo"].double()
        return out

    vh, vp = vals(sh), vals(sp)
    for k in vp:
        scale = max(float(vp[k].abs().max()), 1e-30)
        assert float((vh[k] - vp[k]).abs().max()) <= 1e-4 * scale, k
    return sp


def _sine(amp, T):
    return (amp * np.sin(2 * np.pi * 1000 / 44100 * np.arange(T)))[None, :]


def test_step_clipper(host_lib):
    _, out = host_lib
    fr = FusedRunner(M.diodeclipper_model(), **PROD, device="cpu")
    _compare(load_host(fr.plan, out), fr, _sine(1.5, 64), np.zeros((128, 0)),
             fr.initial_state(128))


def test_step_birdie_pot_lanes(host_lib):
    _, out = host_lib
    fr = FusedRunner(M.birdie_model(), lane_input_idx=(1,), **PROD,
                     device="cpu")
    _compare(load_host(fr.plan, out), fr, _sine(0.3, 32),
             np.linspace(0.05, 0.95, 128)[:, None], fr.initial_state(128))


@pytest.fixture(scope="module")
def superover():
    """The main path's model, built once (each runner centres its own
    copy)."""
    return M.superover_model(drive=None, tone=None, level=1.0,
                             vb_source=True)


def _main_runner(model):
    return FusedRunner(copy.deepcopy(model), lane_input_idx=(1, 2),
                       powerup="steady", **PROD, device="cpu")


def _seeds(fr, lanes):
    return load_steady_seed(os.path.join(ROOT, ".steadyseed_cache.npz"),
                            "seed2_pots_chain_fs44100_L4096", fr, lanes=lanes)


def test_step_superover_from_seeds(host_lib, superover):
    """The main path's production build from the committed seeds: bit for
    bit as the plain version in y, state, fails, floored and iters."""
    _, out = host_lib
    fr = _main_runner(superover)
    lanes = np.array([0, 451, 2048, 3224, 3306, 4095] + list(range(
        700, 4096, 400)))
    lv = S.lane_grid("pots", 4096)[3][lanes]
    _bitwise(load_host(fr.plan, out), fr, _sine(0.2, 16), lv,
             _seeds(fr, lanes))


def test_step_lane_takes_the_redo(host_lib, superover):
    """Eight neighbouring lanes of the main path, one of them (lane 3)
    started off its steady point so that it takes the redo ladder (gated
    Newton, homotopy, df rescue) while the others keep their fast path:
    the build bit for bit as the plain version, the redo on lane 3
    only."""
    _, out = host_lib
    fr = _main_runner(superover)
    lanes = np.arange(1000, 1008)
    state = _seeds(fr, lanes)
    state["zw"][:, 3] *= 0.9
    state["dzdp"][:, 3] = 0.0
    its = _bitwise(load_host(fr.plan, out), fr, _sine(0.2, 4),
                   S.lane_grid("pots", 4096)[3][lanes], state)[3]
    others = np.delete(its.numpy(), 3, axis=1)
    assert (others == others[:, :1]).all()
    assert (its[:, 3].numpy() > others[:, 0]).any()


@pytest.mark.parametrize("case", ["steady", "redo", "full", "full redo"])
def test_step_main_chained_launches_bitwise(host_lib, request, case):
    """A production build run as two chained launches (3 samples, then 5
    from the state the first left) against one launch of all 8: bit for
    bit in y (the two launches' in turn), the state, and fails, iters and
    floored (the two launches' sums), against the host build's one launch
    and against the plain version's.  "steady", "redo": the main path's
    build from the seeds; "redo": lane 3 of the eight starts off its
    steady point and takes the redo ladder (gated Newton, homotopy, df
    rescue) while the others do not.  "full": the full path's build (the
    un-decomposed Super Over's 7x7, its redo's start kept in the carry)
    from where 8 samples of its power-up sibling left 8 input levels;
    "full redo": lane 3's extrapolation there turned the wrong way (dz/dp
    negated), so that it takes more evaluations than from the point
    itself, and more than its samples can take without the redo."""
    _, out = host_lib
    if case.startswith("full"):
        fr = FusedRunner(copy.deepcopy(request.getfixturevalue("full_model")),
                         lane_scale_idx=(0,), powerup="safe", **PROD,
                         device="cpu")
        pr = fr._powerup_runner()
        lane_values = np.linspace(0.1, 2.0, 8)[:, None]
        u, lv, tol, gate = pr.prepare_inputs(_sine(0.2, 8), lane_values)
        state = F.host_step(load_host(pr.plan, out), pr.plan, u, lv, tol,
                            gate, pr.initial_state(8), pr._coef_tables(8))[1]
    else:
        fr = _main_runner(request.getfixturevalue("superover"))
        lanes = np.arange(1000, 1008)
        lane_values = S.lane_grid("pots", 4096)[3][lanes]
        state = _seeds(fr, lanes)
    u, lv, tol, gate = fr.prepare_inputs(_sine(0.2, 8), lane_values)
    coef = fr._coef_tables(8)
    lib = load_host(fr.plan, out)
    if case.endswith("redo"):
        calm = F.host_step(lib, fr.plan, u, lv, tol, gate, state, coef)[3]
        state = {k: v.clone() for k, v in state.items()}
        if case == "full redo":
            state["dzdp"][:, 3] *= -1.0
        else:
            state["zw"][:, 3] *= 0.9
            state["dzdp"][:, 3] = 0.0
    first = F.host_step(lib, fr.plan, u[:3], lv, tol, gate, state, coef)
    second = F.host_step(lib, fr.plan, u[3:], lv, tol, gate, first[1], coef)
    chained = (torch.cat([first[0], second[0]]), second[1]) + tuple(
        a + b for a, b in zip(first[2:], second[2:]))
    for one in (F.host_step(lib, fr.plan, u, lv, tol, gate, state, coef),
                F.plain_run(fr.plan, u, lv, tol, gate, state, coef)):
        for name, c, o in zip(("y", "state", "fails", "iters", "floored"),
                              chained, one):
            if name == "state":
                for k in o:
                    assert torch.equal(c[k], o[k]), k
            else:
                assert torch.equal(c, o), name
    its = chained[3].numpy()
    if case == "full redo":
        # a sample without the redo: the fast path, the polish loop and at
        # most ten verdict passes
        most = 8 * (fr.fast_iters + fr.polish_iters + 10)
        assert its[:, 3].sum() > max(calm[:, 3].sum(), most)
    elif case != "full":
        others = np.delete(its, 3, axis=1)
        assert (others == others[:, :1]).all()
        assert (its[:, 3] > others[:, 0]).any() == (case == "redo")


def test_linear_model_without_subsystems(host_lib):
    _, out = host_lib
    fr = FusedRunner(M.sallenkey_model(), **PROD, device="cpu")
    _compare(load_host(fr.plan, out), fr, _sine(0.5, 32), np.zeros((4, 0)),
             fr.initial_state(4))


@pytest.mark.parametrize("model", ["clipper", "superover_level"])
def test_step_level_powerup_then_main(host_lib, model):
    """The power-up sibling's build (fast_iters=0, extrapolate="track",
    df_polish="final") from cold with lane-scaled inputs, then the
    production build from the state it left (the handoff)."""
    _, out = host_lib
    if model == "clipper":
        fr = FusedRunner(M.diodeclipper_model(), lane_scale_idx=(0,),
                         powerup="safe",
                         **PROD, device="cpu")
        amp, L = 1.5, 64
    else:
        fr = FusedRunner(S.build_model("level", "chain"),
                         lane_scale_idx=(0,), powerup="safe",
                         **PROD, device="cpu")
        amp, L = 0.2, 32
    pr = fr._powerup_runner()
    lv = np.linspace(0.1, 2.0, L)[:, None]
    state = _compare(load_host(pr.plan, out), pr, _sine(amp, 16), lv,
                     pr.initial_state(L))
    _compare(load_host(fr.plan, out), fr, _sine(amp, 16), lv, state)


def clipper_with_r1(r):
    """The diode clipper with another series resistor (the construction of
    tests/test_fused.py's per-lane-model case)."""
    circ = M.diodeclipper()
    circ.delete("r1")
    circ.add("r1", T.resistor(r))
    circ.connect(("r1", 1), ("j_in", "+"))
    circ.connect(("r1", 2), ("d1", "+"))
    return T.DiscreteModel(circ, 1 / 44100)


def _powerup_then_main(out, fr, amp, lv, T_=16):
    """The power-up sibling's build from cold, then the production build
    from the state it left."""
    pr = fr._powerup_runner()
    L = len(lv)
    state = _compare(load_host(pr.plan, out), pr, _sine(amp, T_), lv,
                     pr.initial_state(L), pairs=True)
    _compare(load_host(fr.plan, out), fr, _sine(amp, T_), lv, state,
             pairs=True)


def test_step_per_lane_models_clipper(host_lib):
    """Four clippers as the per-lane models of one runner: the build reads
    the varying coefficients from the lane's (hi, lo) table entries."""
    _, out = host_lib
    fr = FusedRunner([clipper_with_r1(r) for r in (820.0, 1000.0, 1500.0,
                                                   4700.0)],
                     **PROD, device="cpu")
    assert fr.nvar > 0
    _compare(load_host(fr.plan, out), fr, _sine(2.0, 64), np.zeros((64, 0)),
             fr.initial_state(64))
    # lane-scaled, from cold through both builds
    fr = FusedRunner([clipper_with_r1(r) for r in (820.0, 4700.0)],
                     lane_scale_idx=(0,), powerup="safe",
                     **PROD, device="cpu")
    _powerup_then_main(out, fr, 1.5, np.linspace(0.1, 2.0, 64)[:, None])


def test_step_presets_powerup_then_main(host_lib):
    """Three Super Over presets (62 varying coefficients) x 8 levels: the
    presets path's two builds."""
    _, out = host_lib
    models = S.build_models([S.preset_spec(*S.PRESETS[i]) for i in (0, 5, 7)],
                            workers=1)
    fr = FusedRunner(models, lane_scale_idx=(0,), powerup="safe", **PROD,
                     device="cpu")
    assert fr.nvar == 62
    _powerup_then_main(out, fr, 0.2,
                       np.repeat(np.linspace(0.1, 2.0, 8), 3)[:, None])


@pytest.fixture(scope="module")
def full_model():
    return S.build_model("level", "full")


def test_step_full_powerup_then_main(host_lib, full_model):
    """The un-decomposed Super Over: one subsystem with nn 7, np 5 (a
    pivoted 7x7 df elimination with six right-hand columns, and the fold
    loop): the power-up sibling from cold, then the production build from
    the state it left, each bit for bit as the plain version in y, state,
    fails, floored and iters."""
    _, out = host_lib
    fr = FusedRunner(copy.deepcopy(full_model), lane_scale_idx=(0,),
                     powerup="safe", **PROD, device="cpu")
    assert fr.sub_fragile == [True] and fr.plan.subs[0]["fold"]
    pr = fr._powerup_runner()
    lv = np.linspace(0.1, 2.0, 16)[:, None]
    state = _bitwise(load_host(pr.plan, out), pr, _sine(0.2, 8), lv,
                     pr.initial_state(16))[1]
    _bitwise(load_host(fr.plan, out), fr, _sine(0.2, 8), lv, state)


@pytest.mark.parametrize("model,config", [("clipper", c) for c in CONFIGS]
                         + [("superover_level", c) for c in LEVEL_CONFIGS])
def test_step_configurations(host_lib, model, config):
    """Each step configuration's build (the header's COMP, DF_STATE,
    EXTRAP, EXTRAP_USE, PIVOT, POLISH_ONLY, VERIFY_ALWAYS, KEEP_TOL,
    POL_MODE, VERDICT, RESCUE_MODE and REL_* constants) from cold with
    lane-scaled inputs: the clipper (32 levels x 48 samples), the level
    Super Over (8 levels x 12 samples)."""
    _, out = host_lib
    if model == "clipper":
        fr = FusedRunner(M.diodeclipper_model(), lane_scale_idx=(0,),
                         **CONFIGS[config], device="cpu")
        amp, L, n = 1.5, 32, 48
    else:
        fr = FusedRunner(S.build_model("level", "chain"),
                         lane_scale_idx=(0,), **CONFIGS[config],
                         device="cpu")
        amp, L, n = 0.2, 8, 12
    _compare(load_host(fr.plan, out), fr, _sine(amp, n),
             np.linspace(0.1, 2.0, L)[:, None], fr.initial_state(L),
             pairs=True)


def _bitwise(lib, fr, u_time, lane_values, state):
    """The host build against plain_run, bit for bit in y, state, fails,
    floored and iters; returns the plain version's (y, state, fails,
    iters, floored)."""
    u, lv, tol, gate = fr.prepare_inputs(u_time, lane_values)
    L = lv.shape[1]
    args = (fr.plan, u, lv, tol, gate, state, fr._coef_tables(L),
            fr._group(L))
    host = F.host_step(lib, *args)
    plain = F.plain_run(*args)
    for name, h, p in zip(("y", "state", "fails", "iters", "floored"), host,
                          plain):
        if name == "state":
            for k in p:
                assert torch.equal(h[k], p[k]), k
        else:
            assert torch.equal(h, p), name
    return plain


@pytest.mark.parametrize("case", ["fast_step", "polish_only"])
def test_step_lane_groups_bitwise(host_lib, case):
    """A build that couples lane groups (VERIFY_GROUP: each lane of a
    group on a thread of its own, meeting the others at every keep test)
    on the clipper, two groups of 1024 lanes x 48 samples, the first
    group's input levels 0.01 to 3.0 (keep tests fail there), the second's
    0.01 to 0.05 (they never do): bit for bit as the plain version, and
    the redo reaches the passing lanes of the first group only (their
    evaluations against the merge build's)."""
    _, out = host_lib
    kw = dict(PROD, fast_verify="group", group_lanes=1024)
    if case == "polish_only":
        kw.update(fast_iters=0, polish_only=True)
    rng = np.random.default_rng(5)
    lv = np.concatenate([rng.uniform(0.01, 3.0, 1024),
                         rng.uniform(0.01, 0.05, 1024)])[:, None]
    its = {}
    for mode in ("group", "merge"):
        fr = FusedRunner(M.diodeclipper_model(), lane_scale_idx=(0,),
                         **dict(kw, fast_verify=mode), device="cpu")
        assert fr.plan.verify_group == (mode == "group")
        its[mode] = _bitwise(load_host(fr.plan, out), fr, _sine(1.5, 48), lv,
                             fr.initial_state(2048))[3]
    moved = (its["group"] != its["merge"]).any(0)
    assert moved[:1024].any() and not moved[1024:].any()


@pytest.mark.parametrize("mode", ["group", "merge"])
def test_step_batches_at_lane_offsets_bitwise(host_lib, mode):
    """The card launches a build that couples lane groups in batches of
    whole groups, each at its own lane offset (``csrc/fused.cu``
    ``for_batches``, the kernel indexing lanes from ``lane0``); the host
    build goes through the same path: two groups of 1024 run as two
    batches, at lanes 0 and 1024, equal one call bit for bit in y, state,
    fails, floored and iters; a build without groups in batches of 384
    lanes (the last one short) too; a group build's batch of part of a
    group raises."""
    _, out = host_lib
    fr = FusedRunner(M.diodeclipper_model(), lane_scale_idx=(0,),
                     **dict(PROD, fast_verify=mode, group_lanes=1024),
                     device="cpu")
    assert fr.plan.verify_group == (mode == "group")
    lib = load_host(fr.plan, out)
    rng = np.random.default_rng(5)
    lv = np.concatenate([rng.uniform(0.01, 3.0, 1024),
                         rng.uniform(0.01, 0.05, 1024)])[:, None]
    u, lvt, tol, gate = fr.prepare_inputs(_sine(1.5, 24), lv)
    args = (fr.plan, u, lvt, tol, gate, fr.initial_state(2048),
            fr._coef_tables(2048), fr._group(2048))
    whole = F.host_step(lib, *args)
    batched = F.host_step(lib, *args, batch=1024 if mode == "group" else 384)
    for name, b, w in zip(("y", "state", "fails", "iters", "floored"),
                          batched, whole):
        if name == "state":
            for k in w:
                assert torch.equal(b[k], w[k]), k
        else:
            assert torch.equal(b, w), name
    if mode == "group":
        with pytest.raises(RuntimeError, match="not whole lane groups"):
            F.host_step(lib, *args, batch=512)
