"""The port's host runtime and float64 engine against the main path's
golden traces that resume mid-window (tests/golden_torch/
lane<N>_from<S>.npz), on the CPU.

Each starts at sample S of window 1 of its lane, where the fused main
path's departure from the float64 engine peaks, from the engine's carry
there (x, and each subsystem's warm start p, z and dz/dp, saved in the
trace; tests/golden_torch/generate.py).  Cases of one parametrised test:
the host runtime (``runtime.run``, residual tolerance 1e-13) within
-120 dB of the trace's peak, the engine's plain version
(``compile_model(model, device="cpu", tol=1e-12)``, the five as the lanes
of one batch) within -110 dB, as tests/test_torch_golden.py holds the
traces that start at a seed; the runs are tests/golden_torch/score.py's.
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
gen = _load("generate")
RESUMED = sorted(n for n, g in score.GROUP.items() if g == "main resumed")
_ENGINE = {}


@pytest.fixture(scope="module")
def models():
    return {"main resumed": score.S.build_model("pots", "chain", score.FS)}


def test_resumed_traces_present():
    """One trace for each lane of ``generate.RESUME``, from the sample it
    names, carrying the engine's warm starts."""
    assert RESUMED == sorted(f"lane{n}_from{s}"
                             for n, s in gen.RESUME.items())
    for name in RESUMED:
        tr = score.trace(name)
        lane, start = int(tr["lane"]), int(tr["start"])
        assert gen.RESUME[lane] == start
        assert {"x_init", "z_init", "p_init", "dzdp_init"} <= set(tr)
        np.testing.assert_array_equal(tr["u"], gen.lane_input(
            lane, gen.RESUME_T, start))


@pytest.mark.parametrize("runtime_name", ["host", "engine"])
@pytest.mark.parametrize("name", RESUMED)
def test_runtime_matches_resumed_golden(models, name, runtime_name):
    if runtime_name == "host":
        db, bound = score.host_db(models, name), HOST_DB
    else:
        if name not in _ENGINE:
            _ENGINE.update(score.engine_dbs(models, name))
        db, bound = _ENGINE[name], ENGINE_DB
    assert db < bound, f"{name}: {runtime_name} vs golden {db:.1f} dB"
