"""The slice end to end: the port's FusedRunner (plain version, CPU)
against the JAX package, in the production configuration of its bench
(fast_iters=1, polish_fixed=2, df_polish="comp_final", df_solve="auto",
fast_verify="merge").

Bound on y against the JAX kernel: -90 dB of each lane's peak, with
fails and floored equal.  Two float32 implementations whose exp differs
by an ulp can take different solver tiers at a dead-zone crossing, which
is what the bound leaves room for.

The JAX side runs as its own tests run it.  Interpret mode compiles the
whole kernel for the CPU; for models with a df elimination of n >= 3
(birdie's 4x4, the Super Over's 5x5) that compile takes well over ten
minutes here, so those two interpret cases are marked slow, and each has
a tier-1 twin against a float64 reference of the JAX package: the host
runtime (birdie) and the committed bench references ``.hostref_cache.npz``
(Super Over, first T samples of the ``_pw`` windows).
"""

import copy
import os

import numpy as np
import pytest

import jax.numpy as jnp

import acme_tpu as A
from acme_tpu import models as M
from acme_tpu.ops.fused import FusedRunner as JaxRunner
from acme_tpu_torch import FusedRunner
from acme_tpu_torch.convert import (load_steady_seed, state_from_jax,
                                    state_to_jax)
from acme_tpu_torch.sweeps import PRODUCTION
from bench import _lane_grid, _select_parity_lanes, _stress_lanes

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SEEDS = os.path.join(ROOT, ".steadyseed_cache.npz")
REFS = os.path.join(ROOT, ".hostref_cache.npz")
SEED_TAG = "seed2_pots_chain_fs44100_L4096"
PROD = PRODUCTION
FS = 44100


def sine(amp, T):
    return (amp * np.sin(2 * np.pi * 1000 / FS * np.arange(T)))[None, :]


def lane_db(y, ref):
    """Per-lane max |y - ref| relative to each lane's peak, in dB."""
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(y - ref).reshape(len(y), -1).max(1)
    peak = np.maximum(np.abs(ref).reshape(len(ref), -1).max(1), 1e-30)
    return 20 * np.log10(err / peak + 1e-300)


def jax_runner(model, lidx, T):
    return JaxRunner(copy.deepcopy(model), lane_input_idx=lidx,
                     interpret=True, compile_cache=False, time_chunk=T,
                     **PROD)


def compare_with_jax(model, lidx, u, lv, jax_state=None):
    T = u.shape[1]
    jr = jax_runner(model, lidx, T)
    tr = FusedRunner(copy.deepcopy(model), lane_input_idx=lidx, **PROD,
                     device="cpu")
    yj, _, ij = jr.run(u, lv, state=jax_state, check=False)
    state = None if jax_state is None else state_from_jax(jax_state,
                                                             device="cpu")
    yt, _, it = tr.run(u, lv, state=state, check=False)
    db = lane_db(yt.numpy(), np.asarray(yj))
    assert db.max() < -90.0, (db.max(), int(db.argmax()))
    np.testing.assert_array_equal(it.fails.numpy(), np.asarray(ij.fails))
    np.testing.assert_array_equal(it.floored.numpy(),
                                  np.asarray(ij.floored))
    return yt, it


def test_clipper_matches_jax_interpret():
    yt, it = compare_with_jax(M.diodeclipper_model(), (), sine(1.5, 128),
                              np.zeros((128, 0)))
    assert yt.shape == (128, 1, 128)
    assert int(it.fails.sum()) == 0


@pytest.mark.slow
def test_birdie_matches_jax_interpret():
    compare_with_jax(M.birdie_model(), (1,), sine(0.3, 32),
                     np.linspace(0.05, 0.95, 128)[:, None])


def test_birdie_matches_float64_host():
    """Tier-1 twin of the interpret case: the pot as a lane input, cold
    start, against the float64 host runtime on the same model (measured
    -112 dB; bound -100 dB, the JAX package's bound for its full-accuracy
    configurations)."""
    T = 64
    u = sine(0.3, T)
    vols = np.linspace(0.05, 0.95, 128)[:, None]
    tr = FusedRunner(M.birdie_model(), lane_input_idx=(1,), **PROD,
                     device="cpu")
    y, _, info = tr.run(u, vols, check=False)
    assert int(info.fails.sum()) == 0
    for lane in (0, 40, 127):
        yh = A.run(M.birdie_model(), np.vstack([u, np.full((1, T),
                                                           vols[lane, 0])]))
        db = lane_db(y.numpy()[lane:lane + 1], yh[None])[0]
        assert db < -100.0, (lane, db)
    assert not np.allclose(y[0, 0].numpy(), y[127, 0].numpy())


def _superover_lanes():
    """The bench's 18 reference lanes (with the two stress lanes) plus
    seeded others, 128 in all."""
    refs = _select_parity_lanes(4096, 16, _stress_lanes("pots", 4096))
    rng = np.random.default_rng(0)
    others = sorted(set(rng.choice(4096, 256, replace=False).tolist())
                    - set(refs))
    sel = sorted(set(refs) | set(others[:128 - len(refs)]))
    return np.array(sel), refs


@pytest.fixture(scope="module")
def superover():
    return M.superover_model(drive=None, tone=None, level=1.0,
                             vb_source=True)


def _pots():
    _, drive, tone, lv, _ = _lane_grid("pots", 4096)
    return drive, tone, lv


def test_superover_matches_float64_references(superover):
    """The main-path model on 128 lanes cut from the committed 4096-lane
    steady seeds, against the first T samples of the committed float64
    references (window 1 from the same seeds).  Measured: worst -108.9 dB,
    median -110.5 dB; bound -100 dB on every reference lane (no dead-zone
    crossing falls in the first 32 samples; the whole-window bounds,
    -50 worst and -95 median, are chip_smoke.py's)."""
    sel, refs = _superover_lanes()
    assert int(0.78711 * 4096) in sel and int(0.80713 * 4096) in sel
    drive, tone, lv = _pots()
    tr = FusedRunner(superover, lane_input_idx=(1, 2), powerup="steady",
                     **PROD, device="cpu")
    state = load_steady_seed(SEEDS, SEED_TAG, tr, lanes=sel)
    T = 32
    y, st, info = tr.run(sine(0.2, T), lv[sel], state=state, check=False)
    assert int(info.fails.sum()) == 0 and int(info.floored.sum()) == 0
    y = y.numpy()
    assert np.isfinite(y).all()
    with np.load(REFS) as cache:
        for i in refs:
            key = ("scan3_pots_chain_fs44100_T44100_r5_lv1.000000_"
                   f"d{drive[i]:.6f}_t{tone[i]:.6f}_steady")
            scale = np.abs(cache[key + "_st"]).max()
            j = int(np.nonzero(sel == i)[0][0])
            err = np.abs(y[j, 0] - cache[key + "_pw"][:T]).max() / scale
            assert 20 * np.log10(err) < -100.0, (i, 20 * np.log10(err))


@pytest.mark.slow
def test_superover_matches_jax_interpret(superover):
    sel, _ = _superover_lanes()
    _, _, lv = _pots()
    tr = FusedRunner(copy.deepcopy(superover), lane_input_idx=(1, 2),
                     **PROD, device="cpu")
    state = load_steady_seed(SEEDS, SEED_TAG, tr, lanes=sel)
    jr = jax_runner(superover, (1, 2), 32)
    jr._steady_floors = tr._steady_floors
    js = {k: jnp.asarray(v) for k, v in state_to_jax(state).items()}
    yj, _, ij = jr.run(sine(0.2, 32), lv[sel], state=js, check=False)
    yt, _, it = tr.run(sine(0.2, 32), lv[sel], state=state, check=False)
    assert lane_db(yt.numpy(), np.asarray(yj)).max() < -90.0
    np.testing.assert_array_equal(it.fails.numpy(), np.asarray(ij.fails))
    np.testing.assert_array_equal(it.floored.numpy(),
                                  np.asarray(ij.floored))


def test_lanes_are_independent():
    """Per-lane loops: permuting the lanes permutes the results exactly."""
    T = 16
    vols = np.linspace(0.05, 0.95, 128)[:, None]
    perm = np.random.default_rng(3).permutation(128)
    tr = FusedRunner(M.birdie_model(), lane_input_idx=(1,), **PROD,
                     device="cpu")
    y1, s1, i1 = tr.run(sine(0.3, T), vols, check=False)
    y2, s2, i2 = tr.run(sine(0.3, T), vols[perm], check=False)
    np.testing.assert_array_equal(y1.numpy()[perm], y2.numpy())
    np.testing.assert_array_equal(i1.fails.numpy()[perm], i2.fails.numpy())
    for k in s1:
        np.testing.assert_array_equal(s1[k].numpy()[:, perm], s2[k].numpy())


def test_state_carries_across_packages():
    """16 samples in JAX, the state through state_from_jax, 16 more in the
    port == 32 samples in JAX."""
    model = M.diodeclipper_model()
    u = sine(1.5, 32)
    lv = np.zeros((128, 0))
    y32, _, _ = jax_runner(model, (), 32).run(u, lv, check=False)
    _, js, _ = jax_runner(model, (), 16).run(u[:, :16], lv, check=False)
    tr = FusedRunner(copy.deepcopy(model), **PROD, device="cpu")
    y2, _, _ = tr.run(u[:, 16:], lv, state=state_from_jax(js, device="cpu"),
                      check=False)
    db = lane_db(y2.numpy(), np.asarray(y32)[:, :, 16:])
    assert db.max() < -90.0


def test_check_outputs_raises_on_nonfinite():
    """A linear model (nonlinear subsystems substitute the last good z on
    a non-finite solve, which can keep y finite)."""
    tr = FusedRunner(M.sallenkey_model(), **PROD, device="cpu")
    u = sine(0.5, 16)
    u[0, 5] = np.inf
    with pytest.raises(RuntimeError, match="non-finite"):
        tr.run(u, np.zeros((128, 0)))
    with np.errstate(all="ignore"):
        y, _, _ = tr.run(u, np.zeros((128, 0)), check=False)
    assert not np.isfinite(y.numpy()).all()

