"""The level-sweep slice on the CPU: lane-scaled inputs and the two-phase
power-up, the port's plain version against the JAX package.

The JAX bench's input-level sweep (``bench.py:743-765``) fans one audio
stream out to many input levels (``lane_scale_idx=(0,)``) and powers every
lane up from cold in two phases (``powerup="safe"``): the first
``powerup_samples`` run through a sibling runner with the conservative
configuration (``fast_iters=0``: the robust path every sample;
``extrapolate="track"``: start at the last solution but keep the
sensitivity up to date; ``df_polish="final"``: compensated polish and a
df verdict), whose state the production runner then takes over.

Bounds, as in tests/test_torch_fused.py: y within -90 dB of each lane's
peak of the JAX interpret kernel, fails and floored equal; against the
committed float64 references, the bound stated at the test.
"""

import os

import numpy as np
import pytest

from acme_tpu import models as M
from acme_tpu.ops.fused import FusedRunner as JaxRunner
from acme_tpu_torch import FusedRunner
from acme_tpu_torch import models as TM
from acme_tpu_torch import sweeps as S
from acme_tpu_torch.sweeps import PRODUCTION

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFS = os.path.join(ROOT, ".hostref_cache.npz")
PROD = PRODUCTION
SIBLING = dict(fast_iters=0, extrapolate="track", df_polish="final")
FS = 44100
LEVELS = np.linspace(0.1, 2.0, 128)[:, None]


def sine(amp, T):
    return (amp * np.sin(2 * np.pi * 1000 / FS * np.arange(T)))[None, :]


def lane_db(y, ref):
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(y - ref).reshape(len(y), -1).max(1)
    peak = np.maximum(np.abs(ref).reshape(len(ref), -1).max(1), 1e-30)
    return 20 * np.log10(err / peak + 1e-300)


def against_jax(jax_model, port_model, u, lv, chunk, **kw):
    jr = JaxRunner(jax_model, interpret=True, compile_cache=False,
                   time_chunk=chunk, **{**PROD, **kw})
    tr = FusedRunner(port_model, **{**PROD, **kw}, device="cpu")
    yj, sj, ij = jr.run(u, lv, check=False)
    yt, st, it = tr.run(u, lv, check=False)
    db = lane_db(yt.numpy(), np.asarray(yj))
    assert db.max() < -90.0, (db.max(), int(db.argmax()))
    np.testing.assert_array_equal(it.fails.numpy(), np.asarray(ij.fails))
    np.testing.assert_array_equal(it.floored.numpy(),
                                  np.asarray(ij.floored))
    return tr, yt, st, it


def test_clipper_powerup_handoff_matches_jax_interpret():
    """128 levels from 0.1 to 2.0 of a 1.5-amplitude sine (hard clipping
    up to 3 V), cold: samples 1-64 through the power-up sibling, 65-128
    through the production runner from the sibling's state -- both
    configurations and the handoff at sample 65."""
    tr, yt, _, it = against_jax(
        M.diodeclipper_model(), TM.diodeclipper_model(), sine(1.5, 128),
        LEVELS, 64, lane_scale_idx=(0,), powerup="safe",
        powerup_samples=64)
    assert tuple(yt.shape) == (128, 1, 128)
    assert int(it.fails.sum()) == 0
    # the levels really scale the input: the clipped peak grows with it
    peaks = np.abs(yt.numpy()).max(axis=(1, 2))
    assert peaks[-1] > peaks[0] * 2


def test_clipper_sibling_configuration_matches_jax_interpret():
    """The power-up sibling's configuration as a runner of its own."""
    against_jax(M.diodeclipper_model(), TM.diodeclipper_model(),
                sine(1.5, 64), LEVELS, 64, lane_scale_idx=(0,), **SIBLING)


def test_powerup_run_is_sibling_then_main():
    """``run`` from cold is the sibling's run of the first
    ``powerup_samples``, then this runner's from the sibling's state, bit
    for bit; the sibling keeps the sensitivity dz/dp up to date (with
    "track" it does not use it, but the runner after the handoff does)."""
    fr = FusedRunner(TM.diodeclipper_model(), lane_scale_idx=(0,),
                     powerup="safe", powerup_samples=24, **PROD,
                     device="cpu")
    u = sine(1.5, 48)
    y, state, info = fr.run(u, LEVELS, check=False)
    pr = fr._powerup_runner()
    y1, s1, i1 = pr.run(u[:, :24], LEVELS, check=False)
    y2, s2, i2 = fr.run(u[:, 24:], LEVELS, state=s1, check=False)
    np.testing.assert_array_equal(y.numpy(), np.concatenate(
        [y1.numpy(), y2.numpy()], axis=2))
    for k in state:
        np.testing.assert_array_equal(state[k].numpy(), s2[k].numpy())
    np.testing.assert_array_equal(info.iters.numpy(),
                                  (i1.iters + i2.iters).numpy())
    d0 = fr.initial_state(128)["dzdp"].numpy()
    assert not np.array_equal(s1["dzdp"].numpy(), d0)
    assert np.isfinite(s1["dzdp"].numpy()).all()


def test_level_superover_matches_float64_references():
    """The level sweep's model on 128 of its 4096 lanes (the bench's 16
    reference lanes and seeded others), cold: samples 1-32 through the
    power-up sibling, 33-64 through the production runner from its state
    (both configurations and the handoff), against the first T samples of
    the committed float64 power-up references ``_pw``.  Measured: worst
    -107.0 dB (lane 2048), median -114.0 dB; bound -100 dB on every
    reference lane.  The references are not small there: a zero output
    would score +9.9 dB or more (the power-up transient exceeds the steady
    peak), and the test holds each lane above -20 dB."""
    levels, _, _, lvals, cfg = S.lane_grid("level", 4096)
    refs = S.select_parity_lanes(4096, 16, S.stress_lanes("level", 4096))
    rng = np.random.default_rng(0)
    others = sorted(set(rng.choice(4096, 256, replace=False).tolist())
                    - set(refs))
    sel = np.array(sorted(set(refs) | set(others[:128 - len(refs)])))
    tr = FusedRunner(S.build_model("level", "chain"), powerup="safe",
                     powerup_samples=32, **cfg, **PROD,
                     device="cpu")
    assert tr.sub_fragile == [False, False, True]
    T = 64
    y, _, info = tr.run(sine(0.2, T), lvals[sel], check=False)
    assert int(info.fails.sum()) == 0 and int(info.floored.sum()) == 0
    y = y.numpy()
    assert np.isfinite(y).all()
    with np.load(REFS) as cache:
        for i in refs:
            key = S.ref_key("level", "chain", FS, FS, 2, levels[i], 1.0, 1.0)
            scale = np.abs(cache[key + "_st"]).max()
            j = int(np.nonzero(sel == i)[0][0])
            ref = cache[key + "_pw"][:T]
            assert 20 * np.log10(np.abs(ref).max() / scale) > -20.0, i
            err = np.abs(y[j, 0] - ref).max() / scale
            assert 20 * np.log10(err) < -100.0, (i, 20 * np.log10(err))


@pytest.mark.slow
def test_level_superover_matches_jax_interpret():
    """The level Super Over on 128 lanes (the 16 reference lanes and 112
    others), samples 1-16 through the power-up sibling and 17-32 through
    the production runner, against the JAX interpret kernel.  Slow, as the
    pots Super Over's: this case was cut by a 90-minute limit on an
    8-core CPU, still inside the interpret compile (the tier-1 twin is
    test_level_superover_matches_float64_references)."""
    levels, _, _, lvals, cfg = S.lane_grid("level", 4096)
    refs = S.select_parity_lanes(4096, 16, S.stress_lanes("level", 4096))
    sel = np.array(sorted(set(refs) | set(range(1000, 1112))))
    kw = dict(drive=1.0, tone=1.0, level=1.0, vb_source=True)
    against_jax(M.superover_model(**kw), TM.superover_model(**kw),
                sine(0.2, 32), lvals[sel], 16, powerup="safe",
                powerup_samples=16, **cfg)
