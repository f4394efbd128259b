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

from acme_tpu import models as M
from acme_tpu.ops.fused import FusedRunner as JaxRunner
from acme_tpu_torch import FusedRunner
from acme_tpu_torch.convert import state_to_jax


@pytest.fixture(scope="module")
def superover():
    return M.superover_model(drive=None, tone=None, level=1.0,
                             vb_source=True)


def _cases(superover):
    return {
        "clipper": (M.diodeclipper_model(), (), np.zeros((128, 0))),
        "birdie": (M.birdie_model(), (1,),
                   np.linspace(0.05, 0.95, 128)[:, None]),
        "superover": (superover, (1, 2),
                      np.stack([np.repeat(np.linspace(0.05, 0.95, 16), 8),
                                np.tile(np.linspace(0.05, 0.95, 8), 16)],
                               axis=1)),
    }


@pytest.mark.parametrize("case", ["clipper", "birdie", "superover"])
def test_prepared_arrays_equal(case, superover):
    model, lidx, lv = _cases(superover)[case]
    # the centering steady state runs the model's stateful host solvers
    # (CachingSolver), so each runner gets its own copy of the model
    model2 = copy.deepcopy(model)
    jr = JaxRunner(model, lane_input_idx=lidx, interpret=True,
                   compile_cache=False, fast_iters=1, df_polish="comp_final",
                   fast_verify="merge", polish_fixed=2)
    tr = FusedRunner(model2, lane_input_idx=lidx)
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
    # the initial (cold) state, in the JAX layout
    js = jr.initial_state(128)
    ts = state_to_jax(tr.initial_state(128))
    for key, v in ts.items():
        np.testing.assert_array_equal(np.asarray(js[key]), v, err_msg=key)


def test_unported_configurations_raise():
    m = M.diodeclipper_model()
    for kw in (dict(lane_scale_idx=(0,)), dict(powerup="safe"),
               dict(powerup=dict(fast_iters=0)), dict(extrapolate="track"),
               dict(extrapolate=False), dict(compensated=False),
               dict(df_polish="final"), dict(fast_verify="group"),
               dict(polish_only=True), dict(pivot=False),
               dict(verdict_jac="plain"), dict(mesh=object()),
               dict(fast_iters=0)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            FusedRunner(m, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FusedRunner([m, m])
