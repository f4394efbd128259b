"""The port's host runtime and float64 engine against the golden traces.

The traces come from an independent simulator -- arbitrary-precision
mpmath Newton re-implemented from the equations alone (the JAX package's
``acme_tpu/utils/golden.py`` for the seven of tests/golden/, the port's
``acme_tpu_torch/utils/golden.py`` for the main path's of
tests/golden_torch/) -- so they score each runtime of the port against
something that shares none of its code.  Each run starts where its trace
starts (a steady or resumed trace's x_init and z_init, else the model's
own cold start).

Cases of one parametrised test over every trace: the host runtime
(``runtime.run``, residual tolerance 1e-13 as tests/test_golden.py sets
it) within -120 dB of the trace's peak, and the float64 scan engine's
plain version (``compile_model(model, device="cpu", tol=1e-12)``, the
traces of one model as the lanes of one batch) within -110 dB,
``chip_smoke.py``'s gate for the engine's worst lane.  The Sallen-Key
filter is linear (no nonlinear subsystem): the engine's nn = 0 edge
case.  The traces resumed from the engine's carry mid-window are
tests/test_torch_golden_resumed.py's.  The runs and the tables are
tests/golden_torch/score.py's, which prints the dB of each
(tests/test_torch_golden_oracle.py holds the fused runner and the oracle
itself).
"""

import importlib.util
import os

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
HOST_DB = -120.0
ENGINE_DB = -110.0


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"golden_torch_{name}", os.path.join(HERE, "golden_torch",
                                             f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


score = _load("score")
_ENGINE = {}


@pytest.fixture(scope="module")
def models():
    return score.build_models()


def test_main_traces_present():
    """One trace from each named lane's seed, each with its start state and
    the lane's drive and tone as constant input rows."""
    gen = _load("generate")
    assert set(gen.names()) <= set(score.MAIN)
    _, drive, tone, _, _ = score.S.lane_grid("pots", gen.L_GRID)
    for lane in gen.LANES:
        tr = score.trace(f"lane{lane}")
        assert {"u", "y", "x_init", "z_init"} <= set(tr)
        assert tr["u"].shape == (3, gen.T) and tr["y"].shape == (1, gen.T)
        np.testing.assert_array_equal(tr["u"][1:], np.array(
            [[drive[lane]], [tone[lane]]]).repeat(gen.T, axis=1))
        assert np.max(np.abs(tr["y"])) > 0.1


@pytest.mark.parametrize("runtime_name", ["host", "engine"])
@pytest.mark.parametrize("name", sorted(n for n, g in score.GROUP.items()
                                        if g != "main resumed"))
def test_runtime_matches_golden(models, name, runtime_name):
    if runtime_name == "host":
        db, bound = score.host_db(models, name), HOST_DB
    else:
        if name not in _ENGINE:
            _ENGINE.update(score.engine_dbs(models, name))
        db, bound = _ENGINE[name], ENGINE_DB
    assert db < bound, f"{name}: {runtime_name} vs golden {db:.1f} dB"
