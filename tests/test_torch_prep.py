"""The port's runner preparation against the JAX package's.

``acme_tpu_torch.ops.fused.FusedRunner`` reimplements the float64 numpy
preparation of ``acme_tpu.ops.fused.FusedRunner.__init__`` (the JAX
module imports jax and Pallas, so the port cannot import it).  Same code,
same inputs: every prepared array must be identical -- centering, state
balancing, the balanced matrices, q0, tolerances and gates, dz/dp,
the equilibrated condition numbers and the fragile-subsystem flags, the
per-lane tolerances (with steady floors) and the initial state.
"""

import copy

import numpy as np
import pytest
import torch

from acme_tpu import models as M
from acme_tpu.ops.fused import FusedRunner as JaxRunner
from acme_tpu_torch import FusedRunner
from acme_tpu_torch import models as TM
from acme_tpu_torch.convert import state_to_jax
from acme_tpu_torch.sweeps import PRODUCTION as PROD

# name -> (model function, keyword arguments, lane inputs, runner
#          keywords, lanes)
CASES = {
    "clipper": ("diodeclipper_model", {}, (), {}, np.zeros((128, 0))),
    "birdie": ("birdie_model", {}, (1,), {},
               np.linspace(0.05, 0.95, 128)[:, None]),
    "superover": ("superover_model",
                  dict(drive=None, tone=None, level=1.0, vb_source=True),
                  (1, 2), {},
                  np.stack([np.repeat(np.linspace(0.05, 0.95, 16), 8),
                            np.tile(np.linspace(0.05, 0.95, 8), 16)],
                           axis=1)),
    "superover_level": ("superover_model",
                        dict(drive=1.0, tone=1.0, level=1.0,
                             vb_source=True),
                        (), dict(lane_scale_idx=(0,), powerup="safe"),
                        np.linspace(0.1, 2.0, 128)[:, None]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_prepared_arrays_equal(case):
    fn, kw, lidx, rkw, lv = CASES[case]
    # each package builds the model with its own compiler (the centering
    # steady state also runs the model's stateful host solvers, so each
    # runner needs its own model anyway)
    model = getattr(M, fn)(**kw)
    jr = JaxRunner(model, lane_input_idx=lidx, interpret=True,
                   compile_cache=False, fast_iters=1, df_polish="comp_final",
                   fast_verify="merge", polish_fixed=2, **rkw)
    tr = FusedRunner(getattr(TM, fn)(**kw), lane_input_idx=lidx, **rkw,
                     **PROD, device="cpu")
    jp, tp = jr._prep[0], tr.prep
    np.testing.assert_array_equal(jr.Tx, tr.Tx)
    np.testing.assert_array_equal(jr.u_ss, tr.u_ss)
    for key in ("x_ss", "z_ss", "a", "b", "c", "x0", "dy", "ey", "fy",
                "y0"):
        np.testing.assert_array_equal(jp[key], tp[key], err_msg=key)
    for key in ("dq", "eq", "fqprev", "fq", "pexp", "q0", "dzdp0"):
        for k in range(model.nsubsystems):
            np.testing.assert_array_equal(jp[key][k], tp[key][k],
                                          err_msg=f"{key}[{k}]")
    assert jr.tols == tr.tols
    assert jr.gates == tr.gates
    assert jr.sub_cond_eq == tr.sub_cond_eq
    assert jr.sub_fragile == tr.sub_fragile
    # per-lane tolerances, with and without steady floors
    lv_c = np.array(lv, float)
    if lidx:
        lv_c[:, :len(lidx)] -= jr.u_ss[list(lidx)]
    lv_c = lv_c.astype(np.float32)
    for floors in (None, np.random.default_rng(5).uniform(
            0, 1e-6, (128, max(model.nsubsystems, 1)))):
        jr._steady_floors = floors
        tr._steady_floors = floors
        jt, jg = jr._lane_tolerances(lv_c, 1)
        tt, tg = tr._lane_tolerances(lv_c, 128)
        np.testing.assert_array_equal(jt.reshape(jt.shape[0], -1), tt)
        np.testing.assert_array_equal(jg.reshape(jg.shape[0], -1), tg)
    # the initial state, cold and at the centering steady state, in the
    # JAX layout
    for at_steady in (False, True):
        js = jr.initial_state(128, at_steady=at_steady)
        ts = state_to_jax(tr.initial_state(128, at_steady=at_steady))
        for key, v in ts.items():
            np.testing.assert_array_equal(np.asarray(js[key]), v,
                                          err_msg=f"{key} {at_steady}")


def clippers(pkg, rs):
    """Diode clippers of package ``pkg`` (``acme_tpu`` or
    ``acme_tpu_torch``) with other series resistors."""
    out = []
    for r in rs:
        circ = pkg.models.diodeclipper()
        circ.delete("r1")
        circ.add("r1", pkg.resistor(r))
        circ.connect(("r1", 1), ("j_in", "+"))
        circ.connect(("r1", 2), ("d1", "+"))
        out.append(pkg.DiscreteModel(circ, 1 / 44100))
    return out


@pytest.mark.parametrize("at_steady", [False, True])
def test_initial_state_per_lane_models(at_steady):
    """Both forms of ``initial_state`` for three clippers as per-lane
    models: each lane starts at its own model's point, as in the JAX
    runner's arrays; ``at_steady`` puts x, z and wp at zero (the clipper
    at rest is there cold too; test_prepared_arrays_equal's Super Overs
    are not)."""
    import acme_tpu
    import acme_tpu_torch
    rs = (820.0, 1500.0, 4700.0)
    jr = JaxRunner(clippers(acme_tpu, rs), interpret=True,
                   compile_cache=False)
    tr = FusedRunner(clippers(acme_tpu_torch, rs), device="cpu")
    assert tr.nvar > 0
    js = jr.initial_state(256, at_steady=at_steady)
    ts = tr.initial_state(256, at_steady=at_steady)
    for key, v in state_to_jax(ts).items():
        np.testing.assert_array_equal(np.asarray(js[key]), v, err_msg=key)
    if at_steady:
        for key in ("x", "xlo", "z", "zw", "wp"):
            assert (ts[key] == 0).all(), key
    assert not torch.equal(ts["dzdp"][:, 0], ts["dzdp"][:, 1])


def test_unported_configurations_raise():
    """Every configuration is ported: a ``mesh`` that is no sequence of
    devices raises ValueError (tests/test_torch_mesh.py runs valid ones).
    Lane groups (``fast_verify="group"`` with a fast path, whose redo
    couples a lane group) build, also as the power-up sibling's overrides,
    with the build named for it; ``"group"`` without a fast path is
    inert."""
    m = TM.diodeclipper_model()
    with pytest.raises(ValueError, match="mesh must be"):
        FusedRunner(m, mesh=object(), device="cpu")
    for kw in (dict(fast_iters=1), dict(polish_only=True),
               dict(fast_iters=2, fast_verify="group", group_lanes=1024)):
        fr = FusedRunner(m, **kw, device="cpu")
        assert fr.plan.verify_group
        assert fr.plan.kernel_name == "fused_sweep_group"
    for kw in (dict(**PROD, powerup=dict(fast_verify="group")),
               dict(powerup=dict(fast_iters=1)),
               dict(powerup=dict(polish_only=True))):
        pr = FusedRunner(m, **kw, device="cpu")._powerup_runner()
        assert pr.plan.kernel_name == "fused_sweep_powerup_group"
    for kw in (dict(fast_verify="group"), dict(powerup="safe"),
               dict(fast_iters=0, polish_only=False, fast_verify="group")):
        fr = FusedRunner(m, **kw, device="cpu")
        assert not fr.plan.verify_group
    with pytest.raises(ValueError, match="unknown powerup override"):
        FusedRunner(m, powerup=dict(fast_iters=0, grid=4), device="cpu")
    with pytest.raises(ValueError, match="fast_verify must be"):
        FusedRunner(m, fast_verify="some", device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA card")
def test_default_device_is_the_card():
    """A runner runs on the card unless the caller asks for the CPU: with
    no card the default raises instead of running the plain version."""
    m = TM.diodeclipper_model()
    for kw in ({}, dict(device="cuda"), dict(device="cuda:0")):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            FusedRunner(m, **kw)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        FusedRunner([m, copy.deepcopy(m)])
    assert FusedRunner(m, device="cpu").device.type == "cpu"


def test_converter_defaults_to_the_card():
    """The converters of a JAX run's state and tables take the card unless
    the caller asks for the CPU, as every entry point does."""
    import inspect
    from acme_tpu_torch import convert
    for fn in (convert.state_from_jax, convert.coef_from_jax):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    st = convert.state_from_jax(
        {k: np.zeros((1, 1, 128), np.float32) for k in convert.STATE_KEYS},
        device="cpu")
    assert all(v.device.type == "cpu" and v.shape == (1, 128)
               for v in st.values())


def test_state_without_zlo_pmode_runs():
    """A state holding only the six older keys (no ``zlo``, no ``pmode``)
    runs as the JAX runner takes it (fused.py:2967-2970): the same result,
    bit for bit, as with those two keys at zero, through ``run``,
    ``plain_run`` and ``state_from_jax``; the state returned has all
    eight."""
    from acme_tpu_torch import convert
    from acme_tpu_torch.ops import fused as F
    fr = FusedRunner(TM.diodeclipper_model(), lane_scale_idx=(0,), **PROD,
                     device="cpu")
    lv = np.linspace(0.1, 2.0, 128)[:, None]
    u = 1.5 * np.sin(2 * np.pi * 1000 / 44100 * np.arange(48))[None, :]
    _, warm, _ = fr.run(u[:, :16], lv)
    six = {k: v for k, v in warm.items() if k not in ("zlo", "pmode")}
    zero = dict(six, zlo=torch.zeros_like(warm["zlo"]),
                pmode=torch.zeros_like(warm["pmode"]))
    for got, want in ((fr.run(u, lv, state=six), fr.run(u, lv, state=zero)),
                      (fr.run(u, lv, state=convert.state_from_jax(
                          state_to_jax(six), device="cpu")),
                       fr.run(u, lv, state=zero))):
        assert torch.equal(got[0], want[0])
        assert sorted(got[1]) == sorted(F.STATE_KEYS)
        for k in F.STATE_KEYS:
            assert torch.equal(got[1][k], want[1][k]), k
        for a, b in zip(got[2], want[2]):
            # tiers: None while tracing is off
            assert (a is None and b is None) or torch.equal(a, b)
    args = fr.prepare_inputs(u, lv)
    got = F.plain_run(fr.plan, *args, six, fr._coef_tables(128))
    want = F.plain_run(fr.plan, *args, zero, fr._coef_tables(128))
    assert all(torch.equal(got[1][k], want[1][k]) for k in F.STATE_KEYS)
    assert torch.equal(got[0], want[0])


def test_stack_limit_constants_agree():
    """The per-thread stack the launch sets (``csrc/fused.cu``) is the
    figure the build module publishes for checking ptxas's frames."""
    import os
    import re
    from acme_tpu_torch.ops import build
    with open(os.path.join(build.CSRC, "fused.cu")) as f:
        (n,) = re.findall(r"constexpr size_t STACK_BYTES = (\d+);", f.read())
    assert int(n) == build.STACK_BYTES


def test_level_sweep_configurations_build():
    """The knobs of the level sweep (lane-scaled inputs, the two-phase
    power-up and its sibling's configuration) build, with the JAX
    package's semantics: the sibling shares the preparation, has its own
    plan, and takes the overrides."""
    m = TM.diodeclipper_model()
    for kw in (dict(lane_scale_idx=(0,)), dict(extrapolate="track"),
               dict(df_polish="final"), dict(fast_iters=0),
               dict(powerup="safe"), dict(powerup=dict(fast_iters=0)),
               dict(powerup=dict(compensated=True, newton_iters=64))):
        FusedRunner(m, **kw, device="cpu")
    fr = FusedRunner(m, lane_scale_idx=(0,), powerup="safe",
                     powerup_samples=64, **PROD,
                     device="cpu")
    pr = fr._powerup_runner()
    assert pr is fr._powerup_runner() and pr.prep is fr.prep
    assert pr.plan is not fr.plan
    assert (pr.fast_iters, pr.extrapolate, pr.df_polish) == \
        (0, "track", "final")
    assert (fr.fast_iters, fr.extrapolate, fr.df_polish) == \
        (1, True, "comp_final")
    # the sibling: the robust path, a compensated polish loop and a df
    # verdict; production: a plain polish loop and a compensated verdict
    assert (pr.plan.fast, pr.plan.extrap_use, pr.plan.pol_mode,
            pr.plan.verdict, pr.plan.rel_tol_pol) == \
        (0, False, True, "df", 3.0e-8)
    assert (fr.plan.fast, fr.plan.extrap_use, fr.plan.pol_mode,
            fr.plan.verdict, fr.plan.rel_tol_pol) == \
        (1, True, False, True, 3.0e-7)
    assert pr.scale_idx == fr.scale_idx == (0,)
    # the build is named by the sibling's role, not by its knobs
    assert (fr.plan.kernel_name, pr.plan.kernel_name) == \
        ("fused_sweep", "fused_sweep_powerup")
    assert FusedRunner(m, fast_iters=0, extrapolate="track",
                       df_polish="final",
                       device="cpu").plan.kernel_name == "fused_sweep"
    with pytest.raises(ValueError, match="1 columns"):
        fr.prepare_inputs(np.zeros((1, 4)), np.zeros((128, 2)))


def test_op_counts():
    """The bound's operation counts (``emit.op_counts``): one count per
    subsystem; more work for a bigger subsystem, and for the EFT dots of a
    model with more states."""
    from acme_tpu_torch.ops.emit import _solve_ops, op_counts
    clip = op_counts(FusedRunner(TM.diodeclipper_model(), **PROD,
                                 device="cpu").plan)
    bird = op_counts(FusedRunner(TM.birdie_model(),
                                 lane_input_idx=(1,), **PROD,
                                 device="cpu").plan)
    assert len(clip[1]) == 1 and len(bird[1]) == 1
    assert 0 < clip[0] < bird[0] and 0 < clip[1][0] < bird[1][0]
    assert _solve_ops(1, 1) < _solve_ops(2, 1) < _solve_ops(3, 1) \
        < _solve_ops(5, 1) < _solve_ops(5, 3)
    # a per-lane coefficient's EFT term costs its lo * v more: here Eq's
    # entry in p's dot and Fq's in the compensated verdict's q, both of
    # which vary with the clipper's series resistor
    import acme_tpu_torch as T

    def clipper(r):
        circ = TM.diodeclipper()
        circ.delete("r1")
        circ.add("r1", T.resistor(r))
        circ.connect(("r1", 1), ("j_in", "+"))
        circ.connect(("r1", 2), ("d1", "+"))
        return T.DiscreteModel(circ, 1 / 44100)

    many = FusedRunner([clipper(820.0), clipper(4700.0)], **PROD,
                       device="cpu")
    assert many.nvar == 2
    assert op_counts(many.plan) == (clip[0] + 4, clip[1])


def test_df_residual_verdict_computes_only_its_halves():
    """``verdict_jac="plain"`` (the df_res evaluation): its build carries
    the df residual alone and the plain Jacobian alone, and the bound
    prices those, below a full df evaluation; other builds carry
    neither."""
    from acme_tpu_torch.ops.emit import _eval_ops, model_header
    kw = dict(PROD, df_polish="plain_final")
    df = FusedRunner(TM.birdie_model(), lane_input_idx=(1,), **kw,
                     device="cpu").plan
    dfres = FusedRunner(TM.birdie_model(), lane_input_idx=(1,),
                        **dict(kw, verdict_jac="plain"), device="cpu").plan
    assert (df.verdict, dfres.verdict) == ("df", "df_res")
    text = model_header(dfres)
    assert "void nl_df_res(const df* q, df* res)" in text
    assert "void nl_jq(const float* q, float* Jq)" in text
    assert "nl_df_res" not in model_header(df)
    s = dfres.subs[0]
    assert _eval_ops(dfres, s, True) < _eval_ops(dfres, s, "df_res") \
        < _eval_ops(dfres, s, "df")
