"""The branches of the step that need a subsystem of n >= 2, on the CPU:
the port's plain version against float64.

``pivot=False`` (unpivoted main-path eliminations), ``df_solve=True`` (a
df elimination in every subsystem's verdict) and the JAX defaults' df
polish loop (every polish evaluation in df physics, a df elimination in
each on the ill-conditioned subsystems) only differ from the other
configurations where a subsystem has n >= 2.  JAX interpret mode is too
slow for tier 1 on such models (a df elimination of n >= 3 was never seen
to finish compiling: tests/test_torch_fused.py), so the tier-1 cases hold
the port against float64 instead, and the interpret twins are ``slow``:

* birdie (one 4x4 subsystem, its volume pot as a lane input), 128 lanes x
  64 samples from cold, against the JAX package's float64 host runtime
  on three lanes: bound -100 dB of the lane's peak, the bound of
  tests/test_torch_fused.py's production case;
* the level sweep's Super Over (nn [2, 3, 2]), 128 of the bench's 4096
  levels from cold, samples 1-32 through the power-up sibling (which
  keeps these knobs) and 33-64 through the configuration, against the
  first 64 samples of the committed float64 power-up references on the
  bench's 16 reference lanes: bound -100 dB of the steady peak, as in
  tests/test_torch_level.py.

Fails and floored are 0 in every case but ``pivot=False``, whose
unpivoted eliminations miss the acceptance gate on some samples and send
them to the redo (the JAX package's ablation records the same: "pivoting
is load-bearing", STATUS.md): measured 14 fails and 267 floored samples
on birdie, 2 fails on the level Super Over, while the output holds the
-100 dB bound.  Those counts are not asserted.
"""

import numpy as np
import pytest

import acme_tpu as A
from acme_tpu import models as M
from acme_tpu.ops.fused import FusedRunner as JaxRunner
from acme_tpu_torch import FusedRunner
from acme_tpu_torch import models as TM
from acme_tpu_torch import sweeps as S
from acme_tpu_torch.sweeps import PRODUCTION as PROD
from test_torch_level import REFS, lane_db, sine

CONFIGS = {
    "pivot_false": dict(PROD, pivot=False),
    "df_solve_true": dict(PROD, df_polish="plain_final", df_solve=True),
    "df_polish_loop": {},
}
VOLS = np.linspace(0.05, 0.95, 128)[:, None]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_birdie_matches_float64_host(config):
    n = 64
    u = sine(0.3, n)
    tr = FusedRunner(TM.birdie_model(), lane_input_idx=(1,),
                     **CONFIGS[config], device="cpu")
    assert tr.model.nn(0) == 4
    y, _, info = tr.run(u, VOLS, check=False)
    if config != "pivot_false":
        assert int(info.fails.sum()) == 0
    for lane in (0, 40, 127):
        yh = A.run(M.birdie_model(), np.vstack([u, np.full((1, n),
                                                           VOLS[lane, 0])]))
        db = lane_db(y.numpy()[lane:lane + 1], yh[None])[0]
        assert db < -100.0, (lane, db)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_level_superover_matches_float64_references(config):
    levels, _, _, lvals, cfg = S.lane_grid("level", 4096)
    refs = S.select_parity_lanes(4096, 16, S.stress_lanes("level", 4096))
    rng = np.random.default_rng(0)
    others = sorted(set(rng.choice(4096, 256, replace=False).tolist())
                    - set(refs))
    sel = np.array(sorted(set(refs) | set(others[:128 - len(refs)])))
    tr = FusedRunner(S.build_model("level", "chain"), powerup="safe",
                     powerup_samples=32, **cfg, **CONFIGS[config],
                     device="cpu")
    n = 64
    y, _, info = tr.run(sine(0.2, n), lvals[sel], check=False)
    if config != "pivot_false":
        assert int(info.fails.sum()) == 0
    y = y.numpy()
    assert np.isfinite(y).all()
    with np.load(REFS) as cache:
        for i in refs:
            key = S.ref_key("level", "chain", 44100, 44100, 2, levels[i],
                            1.0, 1.0)
            scale = np.abs(cache[key + "_st"]).max()
            j = int(np.nonzero(sel == i)[0][0])
            err = np.abs(y[j, 0] - cache[key + "_pw"][:n]).max() / scale
            assert 20 * np.log10(err) < -100.0, (i, 20 * np.log10(err))


@pytest.mark.slow
@pytest.mark.parametrize("model", ["birdie", "superover_level"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_matches_jax_interpret(model, config):
    """The interpret twins of the two float64 cases, slow as those of
    tests/test_torch_fused.py (not run here): birdie (128 pot lanes x 32
    samples from cold) and the level Super Over (128 levels, samples
    1-16 through the power-up sibling and 17-32 through the
    configuration); y within -90 dB of each lane's peak of the JAX
    kernel, fails and floored equal."""
    kw = dict(CONFIGS[config])
    if model == "birdie":
        jm, tm, lv, u = (M.birdie_model(), TM.birdie_model(), VOLS,
                         sine(0.3, 32))
        kw["lane_input_idx"] = (1,)
    else:
        spec = S.model_spec("level", "chain")
        jm, tm = M.superover_model(**spec), S.build_model("level", "chain")
        lv = S.lane_grid("level", 4096)[3][::32]
        u = sine(0.2, 32)
        kw.update(lane_scale_idx=(0,), powerup="safe", powerup_samples=16)
    jr = JaxRunner(jm, interpret=True, compile_cache=False, time_chunk=32,
                   **kw)
    tr = FusedRunner(tm, **kw, device="cpu")
    yj, _, ij = jr.run(u, lv, check=False)
    yt, _, it = tr.run(u, lv, check=False)
    assert lane_db(yt.numpy(), np.asarray(yj)).max() < -90.0
    np.testing.assert_array_equal(it.fails.numpy(), np.asarray(ij.fails))
    np.testing.assert_array_equal(it.floored.numpy(),
                                  np.asarray(ij.floored))
