"""The un-decomposed Super Over (the bench's ``--model full``) on the CPU.

``superover_model(drive=1, tone=1, level=1, vb_source=False)`` keeps the
whole nonlinear circuit in ONE subsystem (nn 7, np 5, nq 14): its
equilibrated cond(J) is 6.4e4, so the verdict runs df physics, a pivoted
7x7 df elimination with six right-hand columns, and the fold loop.  The
bench sweeps its input level over 4096 lanes from cold with
``powerup="safe"`` (``bench.py:750-751``).

Held here: the preparation against the JAX package's, and 128 lanes x 64
samples from cold across a handoff at sample 32 (both builds'
configurations) against float64: the committed ``scan2_level_full_*_pw``
references on the 8 lanes the cache holds, and the port's float64 host
runtime.  This circuit has no stiff bias source, so its bias rail takes
some 2000 samples to charge and the output stays below 1e-9 of the steady
peak until then: the first 64 samples of a reference are small (asserted,
so that the comparison is not read for more than it says), and the
comparison that can fail here is the state's, which moves from the first
sample on.  The state's reference is the JAX package's own host runtime
(``acme_tpu.run`` on the JAX package's build of the model); the port's
runtime is held to it bit for bit on the way.  A JAX-interpret case would be ``slow`` as its
siblings are (tests/test_torch_fused.py: a df elimination of n >= 3 was
never seen to finish compiling on the CPU; this one is 7x7) and is not
written.
"""

import copy
import os

import numpy as np
import pytest

import acme_tpu as A
from acme_tpu import models as M
from acme_tpu.ops.fused import FusedRunner as JaxRunner
from acme_tpu_torch import FusedRunner, runtime
from acme_tpu_torch import sweeps as S

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFS = os.path.join(ROOT, ".hostref_cache.npz")
FS = 44100
PROD = dict(newton_iters=192, tol=1e-9, fast_iters=1, polish_fixed=2,
            df_polish="comp_final", df_solve="auto", fast_verify="merge")


def sine(amp, n):
    return (amp * np.sin(2 * np.pi * 1000 / FS * np.arange(n)))[None, :]


@pytest.fixture(scope="module")
def full_model():
    """The port's build of the model (about 9 s)."""
    return S.build_model("level", "full", FS)


@pytest.fixture(scope="module")
def jax_model():
    """The JAX package's build of the same model (about 9 s)."""
    return M.superover_model(drive=1.0, tone=1.0, level=1.0, vb_source=False)


def test_full_model_prepares_as_the_jax_package(full_model, jax_model):
    m = full_model
    assert (m.nx, m.nsubsystems) == (11, 1)
    assert (m.nn(0), m.np(0), m.nq(0)) == (7, 5, 14)
    kw = dict(lane_scale_idx=(0,), powerup="safe", powerup_samples=32)
    jr = JaxRunner(copy.deepcopy(jax_model), interpret=True, compile_cache=False, **PROD, **kw)
    tr = FusedRunner(copy.deepcopy(m), **kw, device="cpu")
    assert tr.sub_fragile == jr.sub_fragile == [True]
    assert tr.sub_cond_eq == jr.sub_cond_eq and 1e4 < tr.sub_cond_eq[0] < 1e5
    assert tr.tols == jr.tols and tr.gates == jr.gates
    assert tr.nvar == jr.nvar == 0
    np.testing.assert_array_equal(jr.Tx, tr.Tx)
    for key in ("x_ss", "z_ss", "a", "b", "c", "x0", "dy", "ey", "fy", "y0"):
        np.testing.assert_array_equal(jr._prep[0][key], tr.prep[key],
                                      err_msg=key)
    lv = np.linspace(0.1, 2.0, 128)[:, None].astype(np.float32)
    jt, jg = jr._lane_tolerances(lv, 1)
    tt, tg = tr._lane_tolerances(lv, 128)
    np.testing.assert_array_equal(jt.reshape(jt.shape[0], -1), tt)
    np.testing.assert_array_equal(jg.reshape(jg.shape[0], -1), tg)
    # a pivoted 7x7 df elimination under the fold loop, in both builds
    for plan in (tr.plan, tr._powerup_runner().plan):
        assert plan.subs[0]["df_slv"] and plan.subs[0]["fold"]


def test_full_model_matches_float64_from_cold(full_model, jax_model):
    """128 of the bench's 4096 levels (the 8 reference lanes and seeded
    others), cold, samples 1-32 through the power-up sibling and 33-64
    through the production runner.  y against the committed references
    and the host runtime: bound -100 dB of the steady peak (measured
    -161 dB: the output has not left zero yet).  The reference for the
    state is the JAX package's float64 host runtime on the JAX package's
    model; the port's runtime on the port's model must give the same
    output and state bit for bit.  The state after 64
    samples against that, in the runner's centered and
    balanced coordinates: relative to the lane's largest state, bound
    -100 dB (measured worst -146.6 dB); and the state's MOVEMENT over the
    64 samples relative to the largest movement, bound -60 dB (measured
    worst -70.0 dB: a cold lane sits 219 units from the centering point
    and moves 0.03, so float32's 6e-8 of the former is 1e-4.5 of the
    latter; a solver that stood still would read 0 dB)."""
    levels, _, _, lvals, cfg = S.lane_grid("level", 4096)
    refs = S.select_parity_lanes(4096, 8, [])
    rng = np.random.default_rng(0)
    others = sorted(set(rng.choice(4096, 256, replace=False).tolist())
                    - set(refs))
    sel = np.array(sorted(set(refs) | set(others[:128 - len(refs)])))
    tr = FusedRunner(copy.deepcopy(full_model), powerup="safe",
                     powerup_samples=32, **cfg,
                     device="cpu")
    n = 64
    u = sine(0.2, n)
    y, state, info = tr.run(u, lvals[sel], check=False)
    assert int(info.fails.sum()) == 0 and int(info.floored.sum()) == 0
    y = y.numpy()
    assert np.isfinite(y).all()
    carried = lambda st: (st["x"].double() + st["xlo"].double()).numpy().T
    x, x_cold = carried(state), carried(tr.initial_state(len(sel)))
    worst_y = worst_x = worst_dx = -np.inf
    with np.load(REFS) as cache:
        for i in refs:
            key = S.ref_key("level", "full", FS, FS, 2, levels[i], 1.0, 1.0)
            scale = np.abs(cache[key + "_st"]).max()
            j = int(np.nonzero(sel == i)[0][0])
            ref = cache[key + "_pw"][:n]
            # small: the bias rail has not charged yet
            assert np.abs(ref).max() < 1e-4 * scale, i
            m = copy.deepcopy(full_model)
            yh = runtime.run(m, levels[i] * u)
            jm = copy.deepcopy(jax_model)
            yj = A.run(jm, levels[i] * u)
            np.testing.assert_array_equal(yh, yj)
            np.testing.assert_array_equal(m.x, jm.x)
            np.testing.assert_allclose(yh[0], ref, rtol=0, atol=1e-6 * scale)
            for r in (ref, yh[0]):
                db = 20 * np.log10(np.abs(y[j, 0] - r).max() / scale + 1e-300)
                assert db < -100.0, (i, db)
                worst_y = max(worst_y, db)
            xh = (jm.x - tr.x_ss) / tr.Tx
            db = 20 * np.log10(np.abs(x[j] - xh).max() / np.abs(xh).max())
            assert db < -100.0, (i, db)
            worst_x = max(worst_x, db)
            moved = xh - x_cold[j]
            assert np.abs(moved).max() > 1e-2
            db = 20 * np.log10(np.abs(x[j] - x_cold[j] - moved).max()
                               / np.abs(moved).max())
            assert db < -60.0, (i, db)
            worst_dx = max(worst_dx, db)
    print(f"worst y {worst_y:.1f} dB, state {worst_x:.1f} dB, its movement "
          f"{worst_dx:.1f} dB")
