"""Element physics through acme_tpu_torch.xp against xp=numpy.

Every nonlinear element of tests/test_devices.py's parameter grids runs
its own ``nl(xp, q)`` closure (the circuit-composed subsystem function)
on seeded operating points: in float64 through torch against numpy
(1e-12 of each output row's magnitude: the two libms' exp/tanh differ by
an ulp at most), and in float32 against numpy float32 (1e-5 of each
row's magnitude: float32 rounding of the same expression; 1e-3 for the
Jiles-Atherton core, whose Langevin function coth(x) - 1/x cancels and
amplifies a one-ulp tanh difference).
"""

import math
import zlib

import numpy as np
import pytest
import torch

import acme_tpu as A
import acme_tpu_torch.xp as txp

INF = math.inf


def _bjt_params():
    out = []
    for ile, ilc in ((0, 0), (50e-9, 100e-9)):
        for vaf, var in ((INF, INF), (10, 50)):
            for ikf, ikr in ((INF, INF), (50e-3, 500e-3)):
                for typ in ("npn", "pnp"):
                    out.append(dict(
                        typ=typ, isc=1e-6, ise=2e-6, etac=1.1, etae=1.0,
                        bf=100.0, br=10.0, ile=ile, ilc=ilc, etacl=1.2,
                        etael=1.1, vaf=vaf, var=var, ikf=ikf, ikr=ikr))
    return out


def _elements():
    els = {"diode": A.diode(), "diode_eta": A.diode(is_=1e-9, eta=1.7),
           "pot": A.potentiometer(10e3),
           "mosfet_n": A.mosfet("n", vt=0.7, alpha=2e-5, lam=0.02),
           "mosfet_p_poly": A.mosfet("p", vt=(-0.7, 0.01),
                                     alpha=(2e-5, 1e-6)),
           "opamp_macak": A.opamp(model="macak", gain=1e4, vomin=-3.0,
                                  vomax=4.0),
           "inductor_ja": A.inductor(model="JA", n=50)}
    for i, kw in enumerate(_bjt_params()):
        typ = kw.pop("typ")
        els[f"bjt{i}_{typ}"] = A.bjt(typ, **kw)
    return els


ELEMENTS = _elements()


def _points(name, nq, n=96):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q = rng.uniform(-0.8, 0.8, size=(nq, n))
    if name.startswith("pot"):
        q[4] = rng.uniform(0.05, 0.95, n)
        q[2:4] *= 1e-3
    if name.startswith("inductor"):
        # away from the JA model's branch switches (|q1| < 1e-3 series
        # forms, the sign(q3) == sign(Man - q2) hysteresis test), where a
        # one-ulp difference legitimately flips a branch
        q = rng.uniform(-2.0, 2.0, size=(nq, n))
        q[0] = np.sign(q[0]) * rng.uniform(0.05, 2.0, n)
        q[2] = np.sign(q[2]) * rng.uniform(0.05, 2.0, n)
    return q


def _nl(el):
    circ = A.Circuit()
    circ.add("e", el)
    return circ.nonlinear_eq_func()


@pytest.mark.parametrize("name", sorted(ELEMENTS))
def test_element_physics_float64(name):
    nl = _nl(ELEMENTS[name])
    q = _points(name, nl.nq)
    res_n, J_n = nl(np, q)
    res_t, J_t = nl(txp, torch.from_numpy(q))
    assert res_t.dtype == torch.float64
    _close(res_t.numpy(), res_n, 1e-12, name)
    _close(J_t.numpy(), J_n, 1e-12, name)


def _close(got, ref, tol, name):
    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref).max(axis=-1, keepdims=True) + 1e-300
    assert np.all(np.abs(got - ref) <= tol * scale), name


@pytest.mark.parametrize("name", sorted(ELEMENTS))
def test_element_physics_float32(name):
    nl = _nl(ELEMENTS[name])
    q = _points(name, nl.nq).astype(np.float32)
    with np.errstate(all="ignore"):
        res_n, J_n = nl(np, q)
    res_t, J_t = nl(txp, torch.from_numpy(q))
    assert res_t.dtype == torch.float32 and J_t.dtype == torch.float32
    tol = 1e-3 if name.endswith("_ja") else 1e-5
    _close(res_t.numpy(), res_n, tol, name)
    _close(J_t.numpy(), J_n, tol, name)


def test_scalar_operands():
    t = torch.tensor([70.0, 80.0], dtype=torch.float32)
    assert txp.minimum(t, 73.0).tolist() == [70.0, 73.0]
    assert txp.maximum(75.0, t).tolist() == [75.0, 80.0]
    z = txp.zeros((2, 3), dtype=torch.float64)
    assert z.dtype == torch.float64 and z.shape == (2, 3)
