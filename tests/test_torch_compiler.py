"""The port's own compiler and host runtime against the JAX package's.

``acme_tpu_torch`` carries a copy of the numpy-only compiler modules
(``circuit``, ``element``, ``elements``, ``exact``, ``model``, ``models``)
and of the host runtime (``runtime``, ``solvers``, ``kdtree``), so it
imports nothing of ``acme_tpu``.  Both packages build each model here from
the same netlist; exact rational arithmetic must give the same float64
model bit for bit, so a parity gap between the runtimes never points at a
compiler.  Checked on every model the JAX package's bench and tests use:

* every matrix and offset of the ``DiscreteModel``, bit for bit;
* each subsystem's ``nl_funcs`` (residual and Jacobian) at seeded q, bit
  for bit;
* ``runtime.run`` on a short window, bit for bit;
* ``runtime.steadystate_sweep`` on a few lanes, bit for bit.
"""

import copy

import numpy as np
import pytest

import acme_tpu.models as JM
import acme_tpu.runtime as JR
import acme_tpu_torch.models as TM
import acme_tpu_torch.runtime as TR

FS = 44100
# name -> (model function, keyword arguments, lane inputs to sweep)
MODELS = {
    "clipper": ("diodeclipper_model", {}, ()),
    "sallenkey": ("sallenkey_model", {}, ()),
    "birdie_fixed": ("birdie_model", dict(vol=0.8), ()),
    "birdie_vol": ("birdie_model", {}, (1,)),
    "superover_pots_chain": ("superover_model",
                             dict(drive=None, tone=None, level=1.0,
                                  vb_source=True), (1, 2)),
    "superover_level_chain": ("superover_model",
                              dict(drive=1.0, tone=1.0, level=1.0,
                                   vb_source=True), ()),
    "superover_full": ("superover_model",
                       dict(drive=1.0, tone=1.0, level=1.0), ()),
}
MATRICES = ("a", "b", "c", "x0", "dy", "ey", "fy", "y0")
PER_SUB = ("pexps", "dqs", "eqs", "fqprevs", "fqs", "q0s", "init_zs")

_BUILT = {}


def built(name):
    """(JAX package's model, port's model), built once per name."""
    if name not in _BUILT:
        fn, kw, _ = MODELS[name]
        _BUILT[name] = (getattr(JM, fn)(**kw), getattr(TM, fn)(**kw))
    return _BUILT[name]


def sine(amp, T):
    return amp * np.sin(2 * np.pi * 1000 / FS * np.arange(T))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matrices_bitwise(name):
    jm, tm = built(name)
    assert type(tm).__module__ == "acme_tpu_torch.model"
    assert (jm.nx, jm.nu, jm.ny, jm.nsubsystems) == \
        (tm.nx, tm.nu, tm.ny, tm.nsubsystems)
    for k in range(jm.nsubsystems):
        assert (jm.nn(k), jm.np(k), jm.nq(k)) == (tm.nn(k), tm.np(k),
                                                  tm.nq(k))
    for key in MATRICES:
        a, b = np.asarray(getattr(jm, key)), np.asarray(getattr(tm, key))
        assert a.dtype == b.dtype == np.float64, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    for key in PER_SUB:
        for k, (a, b) in enumerate(zip(getattr(jm, key), getattr(tm, key),
                                       strict=True)):
            np.testing.assert_array_equal(np.asarray(a, float),
                                          np.asarray(b, float),
                                          err_msg=f"{key}[{k}]")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_nl_funcs_bitwise(name):
    jm, tm = built(name)
    rng = np.random.default_rng(11)
    for k in range(jm.nsubsystems):
        q = jm.q0s[k][:, None] + rng.normal(scale=0.5, size=(jm.nq(k), 64))
        with np.errstate(all="ignore"):
            rj, Jj = jm.nl_funcs[k](np, q)
            rt, Jt = tm.nl_funcs[k](np, q)
        np.testing.assert_array_equal(np.asarray(rj), np.asarray(rt))
        np.testing.assert_array_equal(np.asarray(Jj), np.asarray(Jt))


def _inputs(name, nu, T):
    """A 1 kHz sine on input 0; the pots (lane inputs) at fixed travel."""
    u = np.zeros((nu, T))
    u[0] = sine(0.3, T)
    for i, g in enumerate(MODELS[name][2]):
        u[g] = 0.3 + 0.4 * i
    return u


@pytest.mark.parametrize("name", sorted(MODELS))
def test_host_run_bitwise(name):
    # own copies: the host runtime carries state in the model
    jm, tm = (copy.deepcopy(m) for m in built(name))
    u = _inputs(name, jm.nu, 64)
    yj = JR.run(jm, u)
    yt = TR.run(tm, u)
    assert np.isfinite(yt).all()
    np.testing.assert_array_equal(yj, yt)


@pytest.mark.parametrize("name", ["clipper", "birdie_vol",
                                  "superover_level_chain"])
def test_steadystate_sweep_bitwise(name):
    jm, tm = (copy.deepcopy(m) for m in built(name))
    L = 3
    u = np.zeros((L, jm.nu))
    for g in MODELS[name][2]:
        u[:, g] = np.linspace(0.1, 0.9, L)
    if not MODELS[name][2]:
        u[:, 0] = np.linspace(-0.1, 0.1, L)
    outs_j = JR.steadystate_sweep(jm, u, runin=256, return_floors=True)
    outs_t = TR.steadystate_sweep(tm, u, runin=256, return_floors=True)
    for a, b in zip(outs_j, outs_t, strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
