"""The port's golden oracle, the main path's traces and the fused runner
against a trace, on the CPU.

* ``acme_tpu_torch.utils.golden`` against the JAX package's
  ``acme_tpu.utils.golden``, bit for bit: ``golden_run`` on the diode
  clipper over 40 samples, ``golden_steadystate`` on birdie (each package
  on its own build of the model; the builds are equal bit for bit,
  tests/test_torch_compiler.py).
* tests/golden_torch/generate.py still writes the committed traces: lane
  1000's first 16 samples regenerated alone equal the committed trace's,
  its start state and input too, bit for bit.
* The fused runner's plain version in the full path's build
  (``sweeps.build_model("level", "full")``, ``sweeps.PRODUCTION``, input
  level 1.0) over the first 64 samples of ``superover.npz`` from the
  trace's steady state: within -65 dB of the trace's peak, the full
  path's gate, with no failed or floored sample.
* The fused runner's start at a model-coordinate point
  (``FusedRunner._state_at``, which ``steady_initial_state`` ends in and
  ``golden.fused_start`` calls): ``steady_initial_state`` equal to the
  JAX runner's bit for bit (birdie, lanes with repeated pots), and
  ``golden.fused_point`` reading a start back to within its float32
  (hi, lo) rounding.
"""

import importlib.util
import os

import numpy as np
import pytest

from acme_tpu import models as JM
from acme_tpu.ops.fused import FusedRunner as JaxRunner
from acme_tpu.utils import golden as JG
from acme_tpu_torch import FusedRunner
from acme_tpu_torch import models as TM
from acme_tpu_torch.convert import state_to_jax
from acme_tpu_torch.utils import golden as TG

HERE = os.path.dirname(os.path.abspath(__file__))
FS = 44100
FULL_DB = -65.0
PREFIX = 16


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"golden_torch_{name}", os.path.join(HERE, "golden_torch",
                                             f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


score = _load("score")
gen = _load("generate")


@pytest.fixture(scope="module")
def models():
    """The full path's model and the main path's (in worker processes)."""
    full, chain = score.S.build_models([
        score.S.model_spec("level", "full", FS),
        score.S.model_spec("pots", "chain", FS)])
    return {"superover": full, "main": chain}


@pytest.mark.parametrize("case", ["clipper_run", "birdie_steady"])
def test_oracle_equals_jax_bitwise(case):
    if case == "clipper_run":
        u = 0.5 * np.sin(2 * np.pi * 1000 / FS * np.arange(40))[None, :]
        got = TG.golden_run(TM.diodeclipper_model(fs=FS), u)
        want = JG.golden_run(JM.diodeclipper_model(fs=FS), u)
        assert got.shape == (1, 40) and np.max(np.abs(got)) > 0.1
        np.testing.assert_array_equal(got, want)
    else:
        got = TG.golden_steadystate(TM.birdie_model(vol=0.8, fs=FS))
        want = JG.golden_steadystate(JM.birdie_model(vol=0.8, fs=FS))
        for g, w in zip(got, want):
            assert g.size
            np.testing.assert_array_equal(g, w)


def test_generator_reproduces_committed_prefix(models):
    lane = gen.LANES[0]
    (x, z), = gen.seed_points(models["main"], [lane]).values()
    got = gen.seed_trace(models["main"], lane, x, z, T=PREFIX)
    want = score.trace(f"lane{lane}")
    for key in ("x_init", "z_init"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got["u"], want["u"][:, :PREFIX])
    np.testing.assert_array_equal(got["y"], want["y"][:, :PREFIX])


def test_fused_full_prefix_matches_golden(models):
    db, fails, floored = score.fused_full(models)
    assert fails == 0 and floored == 0
    assert db < FULL_DB, f"fused full path vs golden {db:.1f} dB"


def test_fused_start_at_a_point():
    vols = np.tile([0.1, 0.3, 0.3, 0.9, 0.5, 0.5, 0.7, 0.2], 16)[:, None]
    jr = JaxRunner(JM.birdie_model(), lane_input_idx=(1,), interpret=True)
    tr = FusedRunner(TM.birdie_model(), lane_input_idx=(1,), device="cpu")
    want = jr.steady_initial_state(vols)
    got = state_to_jax(tr.steady_initial_state(vols))
    for key, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(want[key]), err_msg=key)
    np.testing.assert_array_equal(tr._steady_floors, jr._steady_floors)
    # a start at a point, read back
    rng = np.random.default_rng(7)
    x, z = rng.normal(size=(2, tr.nx)), rng.normal(size=(2, tr.nn_total))
    xb, zb = TG.fused_point(tr, tr._state_at(x, z, vols[:2]))
    np.testing.assert_allclose(xb, x, rtol=0, atol=1e-12)
    np.testing.assert_allclose(zb, z, rtol=0, atol=1e-12)
