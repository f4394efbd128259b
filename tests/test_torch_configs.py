"""The runner's step configurations on the CPU: the port's plain version
against the JAX package, one knob value at a time.

The JAX package's ``FusedRunner`` runs every configuration of its step
knobs (``acme_tpu/ops/fused.py:303-547``); so does the port (lane groups,
``fast_verify="group"`` with a fast path, are tests/test_torch_groups.py's,
``mesh`` tests/test_torch_mesh.py's).  One case per row
of the table of branches (each knob value over the bench's production
configuration ``PRODUCTION``, or over the JAX defaults where the value
only means something there), the JAX defaults themselves and the ``FAST``
configuration of ``tests/test_fused.py``: the diode clipper, 128 input
levels (0.1 to 2.0) of a 1.5-amplitude sine from cold, 128 samples,
against ``acme_tpu.ops.fused.FusedRunner(..., interpret=True)``.

Bound, as in tests/test_torch_fused.py: y within -90 dB of each lane's
peak, fails and floored equal; and the effort (``hold_effort``): each
lane's Newton evaluations, equal where the JAX kernel counts them per
lane and never more where it counts its lane group's polish trips, and
the port's step configuration equal to the JAX runner's.  ``_ablate.py``'s combined configurations
are in tests/test_torch_configs_ablate.py, with the float64 cases of the
branches that need a subsystem of n >= 2.
"""

import inspect

import numpy as np
import pytest

from acme_tpu import models as M
from acme_tpu.ops.fused import FusedRunner as JaxRunner
from acme_tpu_torch import FusedRunner
from acme_tpu_torch import models as TM
from acme_tpu_torch.sweeps import PRODUCTION as PROD
from torch_step_configs import CONFIGS

FS = 44100
T = 128
LEVELS = np.linspace(0.1, 2.0, 128)[:, None]

# name -> FusedRunner keywords (both packages): the shared table, and the
# knob values that only this comparison holds
CASES = dict(CONFIGS,
             extrapolate_track=dict(PROD, extrapolate="track"),
             df_polish_final=dict(PROD, df_polish="final"),
             # inert: no fast path
             fast_verify_group_no_fast_path=dict(PROD, fast_iters=0,
                                                 fast_verify="group"),
             df_state_false_jax_defaults=dict(df_state=False))


def sine(amp, n):
    return (amp * np.sin(2 * np.pi * 1000 / FS * np.arange(n)))[None, :]


def lane_db(y, ref):
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(y - ref).reshape(len(y), -1).max(1)
    peak = np.maximum(np.abs(ref).reshape(len(ref), -1).max(1), 1e-30)
    return 20 * np.log10(err / peak + 1e-300)


def against_jax(kw, n=T, levels=LEVELS):
    """The clipper from cold in both packages under ``kw``; returns the
    port's (y, state, info) after holding y, fails and floored."""
    jr = JaxRunner(M.diodeclipper_model(), lane_scale_idx=(0,),
                   interpret=True, compile_cache=False, time_chunk=n, **kw)
    tr = FusedRunner(TM.diodeclipper_model(), lane_scale_idx=(0,), **kw,
                     device="cpu")
    u = sine(1.5, n)
    yj, _, ij = jr.run(u, levels, check=False)
    yt, st, it = tr.run(u, levels, check=False)
    db = lane_db(yt.numpy(), np.asarray(yj))
    assert db.max() < -90.0, (db.max(), int(db.argmax()))
    np.testing.assert_array_equal(it.fails.numpy(), np.asarray(ij.fails))
    np.testing.assert_array_equal(it.floored.numpy(),
                                  np.asarray(ij.floored))
    hold_effort(jr, tr, ij, it)
    return yt, st, it


def hold_effort(jr, tr, ij, it):
    """What the knobs that change the steps and not the answer (the redo,
    the keep threshold, the polish prefix, pivoting, the relative
    tolerances) did: the Newton evaluations each lane counted, and the
    step configuration the port's kernel is built with, against the JAX
    runner's."""
    a, b = np.asarray(ij.iters), it.iters.numpy()
    assert a.shape == b.shape
    p = tr.plan
    # an ulp between the two float32 implementations moves a Newton trip
    # or three on a few lanes
    slack = 0.01 * a + 1
    if p.P_pol == 1:
        # one polish trip: both count each lane's own evaluations
        assert (a == b).mean() >= 0.75, (a == b).mean()
        assert (np.abs(b - a) <= slack).all(), np.abs(b - a).max()
    else:
        # the JAX kernel counts the polish loop's trips for its lane group
        # (the loop's counter is one scalar, acme_tpu/ops/fused.py:1875-
        # 1885), the port each lane's own: never more
        assert (b <= a + slack).all(), (b - a).max()
    comp = jr.compensated
    assert (p.K, p.fast, p.fast_path, p.verify_always, p.keep_tol, p.pivot,
            p.dfs, p.comp, p.extrap, p.extrap_use, p.P_pol, p.P_fix) == (
        jr.K, jr.fast_iters, jr.fast_iters > 0 or jr.polish_only,
        jr.fast_verify == "always", jr.fast_keep == "tol", jr.pivot,
        jr.df_state, comp, bool(jr.extrapolate), jr.extrapolate is True,
        jr.polish_iters if comp else 1, jr.polish_fixed if comp else 0)
    for mine, theirs in ((p.rel_tol, jr.rel_tol), (p.rel_gate, jr.rel_gate),
                         (p.rel_tol_pol, jr.rel_tol_polish)):
        assert theirs is None or mine == theirs


@pytest.mark.parametrize("case", sorted(CASES))
def test_configuration_matches_jax_interpret(case):
    yt, st, it = against_jax(CASES[case])
    assert np.isfinite(yt.numpy()).all()
    # the levels really scale the input: the clipped peak grows with it
    peaks = np.abs(yt.numpy()).max(axis=(1, 2))
    assert peaks[-1] > 2 * peaks[0]
    # the state keeps its keys in every configuration
    assert sorted(st) == ["dzdp", "pmode", "wp", "x", "xlo", "z", "zlo",
                          "zw"]


def run_both(kw, n=T, levels=LEVELS):
    """Each lane's evaluations in both packages under ``kw`` (JAX, port)."""
    jr = JaxRunner(M.diodeclipper_model(), lane_scale_idx=(0,),
                   interpret=True, compile_cache=False, time_chunk=n, **kw)
    tr = FusedRunner(TM.diodeclipper_model(), lane_scale_idx=(0,), **kw,
                     device="cpu")
    u = sine(1.5, n)
    ij = jr.run(u, levels, check=False)[2]
    it = tr.run(u, levels, check=False)[2]
    return np.asarray(ij.iters, np.int64), it.iters.numpy().astype(np.int64)


@pytest.mark.parametrize("case", ["fast_verify_always", "fast_keep_tol"])
def test_redo_effort_matches_jax_interpret(case):
    """The redo knobs change the effort and not the answer.  Both
    packages count the redo's evaluations per lane, so what each knob adds
    to the production configuration's count is the same lane by lane (an
    ulp moves a few trips on a few lanes), though the JAX kernel's count
    of the polish loop is its lane group's."""
    a0, b0 = run_both(PROD)
    a, b = run_both(CASES[case])
    da, db = a - a0, b - b0
    assert da.mean() > 0.5
    assert (da == db).mean() >= 0.75, (da == db).mean()
    assert abs(db.mean() - da.mean()) <= 0.01 * da.mean() + 0.1


def test_constructor_defaults_are_the_jax_packages():
    """Every keyword the two runners share has the same default; the port
    adds ``device`` and drops only the Mosaic-only ones (``group_lanes``
    is the JAX package's and defines the lane groups)."""
    jp = inspect.signature(JaxRunner).parameters
    tp = inspect.signature(FusedRunner).parameters
    assert set(jp) - set(tp) == {"time_chunk", "interpret", "compile_cache"}
    assert set(tp) - set(jp) == {"device"}
    for name in set(jp) & set(tp):
        assert tp[name].default == jp[name].default, name
        assert tp[name].kind == jp[name].kind, name


def test_default_runner_is_the_jax_configuration():
    """``FusedRunner(model, device="cpu")`` casts its knobs as the JAX
    runner does: the robust path every sample, the early-exit df polish
    loop (no prefix, no verdict), df solves on the fragile subsystems."""
    jr = JaxRunner(M.diodeclipper_model(), interpret=True,
                   compile_cache=False)
    tr = FusedRunner(TM.diodeclipper_model(), device="cpu")
    for attr in ("fast_iters", "polish_fixed", "df_polish", "df_solve",
                 "fast_verify", "verdict_jac", "extrapolate", "compensated",
                 "df_state", "pivot", "polish_only", "fast_keep",
                 "polish_iters", "verdict_refine"):
        assert getattr(tr, attr) == getattr(jr, attr), attr
    p = tr.plan
    assert (p.fast_path, p.pol_mode, p.verdict, p.P_fix, p.rel_tol_pol) \
        == (False, "df", None, 0, 3.0e-9)


def test_uncompensated_casts_as_the_jax_package():
    """``compensated=False`` degrades ``df_polish`` to False (so no
    verdict and no df solve), the polish to one plain step, the floors to
    the plain float32 ones; the power-up sibling's "final" degrades too
    (fused.py:492-495, :1339-1364, :2833-2838)."""
    for kw in (dict(compensated=False), dict(compensated=False,
                                              df_polish="comp_final")):
        jr = JaxRunner(M.diodeclipper_model(), interpret=True,
                       compile_cache=False, **kw)
        tr = FusedRunner(TM.diodeclipper_model(), device="cpu", **kw)
        assert tr.df_polish is False and jr.df_polish is False
        assert tr.df_solve == jr.df_solve
        assert (tr.plan.P_pol, tr.plan.P_fix, tr.plan.pol_mode,
                tr.plan.verdict, tr.plan.rel_gate_f) == \
            (1, 0, False, None, 4.0e-6)
        lv = LEVELS.astype(np.float32)
        jt, jg = jr._lane_tolerances(lv, 1)
        tt, tg = tr._lane_tolerances(lv, 128)
        np.testing.assert_array_equal(jt.reshape(jt.shape[0], -1), tt)
        np.testing.assert_array_equal(jg.reshape(jg.shape[0], -1), tg)
    fr = FusedRunner(TM.diodeclipper_model(), lane_scale_idx=(0,),
                     powerup="safe", compensated=False, fast_iters=1,
                     fast_verify="merge", device="cpu")
    pr = fr._powerup_runner()
    assert (pr.df_polish, pr.fast_iters, pr.extrapolate) == \
        (False, 0, "track")


def test_uncompensated_powerup_handoff_matches_jax_interpret():
    """The FAST-like configuration with the fast path, from cold through
    the power-up sibling (which degrades its df verdict away) and the
    handoff."""
    against_jax(dict(compensated=False, fast_iters=1, fast_verify="merge",
                     powerup="safe", powerup_samples=64))
